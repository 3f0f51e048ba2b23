"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each source becomes a shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` (Hopper) at first use into ``build/repro_torch/``
at the repository root.  A library's file name carries a hash of its source
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built or loaded at import time: callers ask for a library when
they are about to launch one of its kernels.  ``ptxas`` reports each
kernel's registers, shared memory and spills (``-Xptxas -v``); the report
is kept beside the library (``build_log``).  ``defines`` (``NAME=VALUE``
strings, passed as ``-D``) build a variant of a source beside its default
library, as a measurement sweeps a compile-time constant.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(defines: Sequence[str] = ()):
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str], defines: Sequence[str] = ()) -> None:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together; raise with the compiler's output
    if any of them fails."""
    todo = [(n, library_path(n, defines)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        else:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build_log(name: str, defines: Sequence[str] = ()) -> str:
    """The compiler's output (with the ``ptxas`` report) of the build of
    ``csrc/<name>.cu``, or "" if it has not been built here."""
    log = library_path(name, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name, defines)
    lib = _loaded.get(str(path))
    if lib is None:
        build([name], defines)
        lib = ctypes.CDLL(str(path))
        _loaded[str(path)] = lib
    return lib
