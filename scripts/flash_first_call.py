#!/usr/bin/env python3
"""The short first call on the GPU after a change to the bf16 flash kernel.

    python3 scripts/flash_first_call.py

From the root of a checkout, on a machine with an NVIDIA Hopper card:
builds ``src/repro_torch/csrc/flash_attention.cu``, prints each bf16
instance's registers, spills and shared memory, holds the kernel against
its plain version at small shapes first (one tile, two tiles, ragged S,
S = 1, every head-dim pair, three Q/K panels at Dk 192) and then at the
three prefill shapes, within the reference's bf16 tolerance 2.5e-2, and
times those shapes back to back with a warm L2 (mean of 50 calls between
two CUDA events).  Exits non-zero at the first case that fails;
``chip_smoke.py`` is the full run.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, S, H, KV, Dk, Dv, causal), smallest first
CASES = [(1, 64, 1, 1, 64, 64, True), (1, 128, 1, 1, 64, 64, True),
         (1, 128, 1, 1, 64, 64, False), (2, 77, 4, 2, 64, 64, True),
         (1, 128, 1, 1, 64, 128, True), (1, 128, 2, 1, 128, 128, True),
         (1, 200, 4, 4, 96, 64, True), (1, 100, 4, 2, 16, 16, True),
         (2, 33, 4, 4, 24, 16, True), (3, 1, 4, 2, 64, 64, True),
         (1, 130, 6, 2, 96, 128, False), (1, 300, 6, 2, 128, 64, True),
         # three Q/K panels (deepseek-v2-lite's MLA prefill head dims)
         (1, 64, 1, 1, 192, 128, True), (1, 128, 1, 1, 192, 128, False),
         (1, 128, 2, 1, 192, 128, True), (2, 77, 4, 2, 192, 128, True),
         (1, 300, 16, 16, 192, 128, False),
         (4, 1024, 32, 4, 64, 64, True), (2, 1024, 40, 40, 96, 64, True),
         (2, 1024, 16, 16, 192, 128, True)]
PREFILL = [(4, 1024, 32, 4, 64, 64), (2, 1024, 40, 40, 96, 64),
           (2, 1024, 16, 16, 192, 128)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_first_call: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build(["flash_attention"])
    chip_smoke.ptxas_report(build.build_log("flash_attention"), fa)
    for i, (B, S, H, KV, Dk, Dv, causal) in enumerate(CASES):
        q, k, v = chip_smoke.flash_inputs(torch, B, S, H, KV, Dk, Dv,
                                          "bfloat16", i)
        out = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  B={B} S={S} H={H} KV={KV} Dk={Dk} Dv={Dv} "
              f"{'causal' if causal else 'full'}: max|diff| {err:.3e}")
        if err > 2.5e-2:
            print("flash_first_call: FAILED", file=sys.stderr)
            return 1
    for i, (B, S, H, KV, Dk, Dv) in enumerate(PREFILL):
        q, k, v = chip_smoke.flash_inputs(torch, B, S, H, KV, Dk, Dv,
                                          "bfloat16", 100 + i)
        for _ in range(3):
            fa.flash_attention(q, k, v)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(50):
            fa.flash_attention(q, k, v)
        b.record()
        torch.cuda.synchronize()
        print(f"  B={B} S={S} H={H} KV={KV} Dk={Dk} Dv={Dv} causal: "
              f"{a.elapsed_time(b) / 50:.4f} ms a call (back to back, L2 "
              "warm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
