#!/usr/bin/env python3
"""The short first call on the GPU after a change to the paged kernels.

    python3 scripts/decode_first_call.py [--root DIR] [--time-only]
                                         [--chunks]

On a machine with an NVIDIA Hopper card: builds
``src/repro_torch/csrc/paged_attention.cu`` of the checkout at DIR (by
default the one holding this script).  Without ``--time-only`` it prints
the kernel's ``ptxas`` report and runs every check of the three paged
kernels in this script's ``chip_smoke.py`` (``check_paged_all``: each
against its plain version, ``paged_attention`` bitwise
``fused_decode_attention``, every verify case bitwise chained decode
launches, a lane alone bitwise among 64).  Then it times
``chip_smoke.paged_calls`` (the two decode kernels and the verify kernel
at W=1 and W=5 at the timing shape B=8, ctx 512; at shorter contexts; with
every width 0, the launch's floor; at the serving shape, 64 lanes with 8
live at ctx 240), L2 flushed, median of CUDA events.  ``--chunks`` then
times them again with the kernels built at each chunk length of
``chip_smoke.CHUNKS``.  ``--time-only`` skips the checks, so that an older
checkout (the parent commit, unpacked) can be timed beside this one in
the same call: only the wrappers' public functions are used then.  Exits
non-zero at the first check that fails; ``chip_smoke.py`` is the full run.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--chunks", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_first_call: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    # this checkout's chip_smoke.py, the kernels of the one at DIR
    sys.path[:0] = [HERE, os.path.join(root, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"checkout {root}")
    sweep = args.chunks and not args.time_only
    if sweep:
        cs.build_all(build, ["paged_attention"], pa.CHUNK)
    else:
        build.build(["paged_attention"])
    if not args.time_only:
        cs.paged_ptxas_report(build.build_log("paged_attention"), pa)
        cs.check_paged_all(torch, pa)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    for label, fn in cs.paged_calls(torch, pa).items():
        print(f"  {label}: {cs.median_ms(torch, fn, flush):.4f} ms")
    if sweep:
        cs.chunk_sweep(torch, pa, build, flush, pa.CHUNK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
