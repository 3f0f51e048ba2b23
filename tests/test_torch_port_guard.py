"""Guards of the PyTorch port (src/repro_torch): the modules copied from the
JAX package stay equal to their originals, the port and chip_smoke.py
import nothing of JAX or of the JAX package, the backend runs on the GPU
unless asked for the CPU, and the kernel wrappers validate their arguments
before they dispatch on the device."""

import ast
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# modules the port copies verbatim, only the package name in imports changed
VERBATIM = [
    "obs/__init__.py", "obs/metric.py", "obs/trace.py", "obs/export.py",
    "core/__init__.py", "core/qrf.py", "core/predictor.py", "core/dag.py",
    "core/service.py", "core/slo_tracker.py", "core/scheduler.py",
    "core/gmg.py", "core/baselines.py",
    "serving/request.py", "serving/kvcache.py", "serving/workload.py",
    "serving/metrics.py", "serving/engine.py", "serving/drafter.py",
    "configs/base.py", "configs/tinyllama_1p1b.py", "configs/minicpm3_4b.py",
    "configs/deepseek_v2_lite_16b.py", "configs/kimi_k2_1t_a32b.py",
    "configs/yi_34b.py", "configs/minitron_4b.py",
    "configs/jamba_v0p1_52b.py", "configs/xlstm_1p3b.py",
    "configs/musicgen_medium.py", "configs/pixtral_12b.py", "configs/archs.py",
    "cluster/__init__.py", "cluster/engine.py", "cluster/router.py",
    "cluster/autoscaler.py", "launch/dashboard.py",
    "training/fault_tolerance.py",
]
_IMPORT = re.compile(r"^(\s*)(from|import) repro(?=[.\s])", re.M)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_original(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == _IMPORT.sub(r"\1\2 repro_torch", original)


def _port_modules():
    pkg = SRC / "repro_torch"
    return sorted("repro_torch." + ".".join(p.relative_to(pkg).with_suffix(
        "").parts).replace(".__init__", "") for p in pkg.rglob("*.py"))


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Import every port module in a fresh interpreter whose meta-path
    finder refuses ``jax`` and ``repro``."""
    mods = _port_modules()
    assert {"repro_torch.serving.torch_backend",
            "repro_torch.serving.prng",
            "repro_torch.kernels.flash_attention",
            "repro_torch.launch.steps",
            "repro_torch.launch.serve",
            "repro_torch.models.attention",
            "repro_torch.models.moe",
            "repro_torch.examples",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_cluster",
            "repro_torch.examples.serve_mixed_slo",
            "repro_torch.examples.agentic_pipeline",
            "repro_torch.examples.train_lm",
            "repro_torch.training",
            "repro_torch.training.optimizer",
            "repro_torch.training.compression",
            "repro_torch.training.checkpoint",
            "repro_torch.training.fault_tolerance",
            "repro_torch.data",
            "repro_torch.data.pipeline",
            "repro_torch.launch.train"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("port must not import " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(SRC)!r})
        for m in {mods!r}:
            importlib.import_module(m)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not leaked, leaked
        print("ok", len({mods!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


def test_flash_first_call_imports_no_jax():
    """Like ``chip_smoke.py``, it runs on the GPU machine, which has no
    JAX."""
    roots = _imported_roots(ROOT / "scripts" / "flash_first_call.py")
    assert {"repro_torch", "chip_smoke"} <= roots
    assert not roots & {"jax", "jaxlib", "repro"}


def test_verify_first_call_imports_no_jax():
    """The paged kernels' first call on the GPU machine (decode, attend
    and verify kernels alike) imports no JAX either."""
    roots = _imported_roots(ROOT / "scripts" / "decode_first_call.py")
    assert {"repro_torch", "chip_smoke"} <= roots
    assert not roots & {"jax", "jaxlib", "repro"}


def test_backend_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid here")
    from repro_torch.serving.torch_backend import PagedTorchBackend
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedTorchBackend()


def _args(dtype=torch.float32, B=2, H=4, KV=2, D=8, P=5, page=4, n_max=2):
    q = torch.zeros(B, H, D, dtype=dtype)
    pool = torch.zeros(P, page, KV, D, dtype=dtype)
    tables = torch.zeros(B, n_max, dtype=torch.int32)
    lens = torch.ones(B, dtype=torch.int32)
    rows = torch.zeros(B, KV, D, dtype=dtype)
    return dict(q=q, k_pages=pool, v_pages=pool.clone(), tables=tables,
                lens=lens, k_new=rows, v_new=rows.clone())


BAD = {
    "int64 tables": dict(tables=torch.zeros(2, 2, dtype=torch.int64)),
    "float16 q": dict(q=torch.zeros(2, 4, 8, dtype=torch.float16)),
    "q dtype != pools": dict(q=torch.zeros(2, 4, 8, dtype=torch.bfloat16)),
    "KV does not divide H": dict(q=torch.zeros(2, 3, 8)),
    "head dim mismatch": dict(q=torch.zeros(2, 4, 16)),
    "pools differ": dict(v_pages=torch.zeros(6, 4, 2, 8)),
    "tables batch": dict(tables=torch.zeros(3, 2, dtype=torch.int32)),
    "lengths shape": dict(lens=torch.ones(2, 1, dtype=torch.int32)),
    "non-contiguous q": dict(q=torch.zeros(2, 8, 4).transpose(1, 2)),
    "new rows shape": dict(k_new=torch.zeros(2, 1, 8)),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrappers_validate_before_dispatch(bad):
    from repro_torch.kernels import paged_attention as pa
    a = _args()
    a.update(BAD[bad])
    before = dict(pa.launches)
    with pytest.raises(ValueError):
        pa.fused_decode_attention(a["q"], a["k_new"], a["v_new"],
                                  a["k_pages"], a["v_pages"], a["tables"],
                                  a["lens"])
    if bad != "new rows shape":
        with pytest.raises(ValueError):
            pa.paged_attention(a["q"], a["k_pages"], a["v_pages"],
                               a["tables"], a["lens"])
    assert pa.launches == before


def _flash_args(dtype=torch.float32, B=2, S=5, H=4, KV=2, Dk=16, Dv=16):
    return dict(q=torch.zeros(B, S, H, Dk, dtype=dtype),
                k=torch.zeros(B, S, KV, Dk, dtype=dtype),
                v=torch.zeros(B, S, KV, Dv, dtype=dtype))


FLASH_BAD = {
    "float16": dict(q=torch.zeros(2, 5, 4, 16, dtype=torch.float16)),
    "k dtype != q": dict(k=torch.zeros(2, 5, 2, 16, dtype=torch.bfloat16)),
    "KV does not divide H": dict(q=torch.zeros(2, 5, 3, 16)),
    "unsupported head dim": _flash_args(Dk=80, Dv=80),
    "unsupported Dk/Dv pair": _flash_args(Dk=16, Dv=64),
    "non-contiguous q": dict(q=torch.zeros(2, 4, 5, 16).transpose(1, 2)),
    "non-contiguous v": dict(v=torch.zeros(2, 5, 16, 2).transpose(2, 3)),
    "k length": dict(k=torch.zeros(2, 6, 2, 16)),
    "3-d q": dict(q=torch.zeros(2, 5, 64)),
}


@pytest.mark.parametrize("bad", sorted(FLASH_BAD))
def test_flash_wrapper_validates_before_dispatch(bad):
    from repro_torch.kernels import flash_attention as fa
    a = _flash_args()
    a.update(FLASH_BAD[bad])
    before = dict(fa.launches)
    with pytest.raises(ValueError):
        fa.flash_attention(a["q"], a["k"], a["v"])
    assert fa.launches == before
