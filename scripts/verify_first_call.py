#!/usr/bin/env python3
"""The short first call on the GPU after a change to the paged kernels.

    python3 scripts/verify_first_call.py [--root DIR] [--time-only]

On a machine with an NVIDIA Hopper card: builds
``src/repro_torch/csrc/paged_attention.cu`` of the checkout at DIR (by
default the one holding this script), prints the verify kernel's
registers, spills and shared memory, holds ``fused_verify_attention``
against its plain version and bitwise against chained
``fused_decode_attention`` launches at every verify case of that
checkout's ``chip_smoke.py``, and the decode kernels against their plain
versions at the main path's shapes.  Then it times the three kernels at
``chip_smoke.py``'s timing shape (B=8, H=32, KV=4, D=64, page 16, ctx 512,
bf16; the verify kernel with W=5 rows, the last at ctx 512), L2 flushed,
median of CUDA events.  Without ``--time-only`` it also times the verify
kernel at contexts 64, 128 and 256 (what a 64-token tile adds), and with
other numbers of (row, head) tasks per block than the wrapper's choice,
from 1 (a block per task) to all 40 of a lane's kv-head (one pass over
the pages for the whole window), each bitwise equal to the wrapper's
output.  ``--time-only`` skips the checks, so that an older checkout
(the parent commit, unpacked) can be timed beside this one in the same
call.  Exits non-zero at the first check that fails; ``chip_smoke.py`` is
the full run.
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("verify_first_call: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"checkout {root}")
    build.build(["paged_attention"])
    if not args.time_only:
        chip_smoke.verify_ptxas_report(build.build_log("paged_attention"),
                                       pa)
        chip_smoke.check_verify_all(torch, pa)
        for B, ctxs in ((1, [512]), (8, [1, 15, 16, 17, 100, 256, 511,
                                         512])):
            c = chip_smoke.case(torch, B, 32, 4, 64, 16, ctxs,
                                torch.bfloat16, seed=B)
            chip_smoke.check_kernels(torch, pa, c, 2e-2,
                                     f"bf16 B={B} H=32 KV=4 D=64")
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    B, H, KV, D, page, ctx, W = 8, 32, 4, 64, 16, 512, 5
    c = chip_smoke.case(torch, B, H, KV, D, page, [ctx] * B, torch.bfloat16,
                        seed=7)
    cv = chip_smoke.verify_case(torch, B, W, H, KV, D, page,
                                [ctx - W + 1] * B, [W] * B, torch.bfloat16,
                                seed=8)
    calls = {
        "fused_verify_attention": lambda: pa.fused_verify_attention(
            cv["q"], cv["k_new"], cv["v_new"], cv["k_pages"], cv["v_pages"],
            cv["tables"], cv["pos0"], cv["widths"]),
        "fused_decode_attention": lambda: pa.fused_decode_attention(
            c["q"], c["k_new"], c["v_new"], c["k_pages"], c["v_pages"],
            c["tables"], c["ctx"] - 1),
        "paged_attention": lambda: pa.paged_attention(
            c["q"], c["k_pages"], c["v_pages"], c["tables"], c["ctx"])}
    for name, fn in calls.items():
        ms = chip_smoke.median_ms(torch, fn, flush)
        print(f"  {name}: {ms:.4f} ms (B={B} H={H} KV={KV} D={D} ctx={ctx}"
              f"{f' W={W}' if 'verify' in name else ''}, bf16, L2 flushed)")
    if args.time_only:
        return 0
    for ctx_s in (64, 128, 256):   # the time a 64-token tile adds
        cs = chip_smoke.verify_case(torch, B, W, H, KV, D, page,
                                    [ctx_s - W + 1] * B, [W] * B,
                                    torch.bfloat16, seed=8)
        ms = chip_smoke.median_ms(torch, lambda: pa.fused_verify_attention(
            *(cs[k] for k in ("q", "k_new", "v_new", "k_pages", "v_pages",
                              "tables", "pos0", "widths"))), flush)
        print(f"  fused_verify_attention at ctx {ctx_s}: {ms:.4f} ms")
    want, _, _ = calls["fused_verify_attention"]()
    for per in (1, 2, 4, 8, 16, 40):
        out = torch.empty_like(cv["q"])

        def launch():
            err = pa._kernels().fused_verify_attention_launch(
                *(cv[k].data_ptr() for k in ("q", "k_new", "v_new",
                                             "k_pages", "v_pages", "tables",
                                             "pos0", "widths")),
                out.data_ptr(), B, W,
                *pa._geometry(cv["q"], cv["k_pages"], cv["tables"], None),
                per, torch.cuda.current_stream().cuda_stream)
            chip_smoke.check(err == 0, f"verify launch at {per} tasks per "
                             f"block: CUDA error {err}")

        ms = chip_smoke.median_ms(torch, launch, flush)
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(out, want),
                         f"verify at {per} tasks per block differs")
        print(f"  fused_verify_attention at {per} tasks per block "
              f"({-(-W * H // KV // per)} blocks per lane and kv-head): "
              f"{ms:.4f} ms, bitwise equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
