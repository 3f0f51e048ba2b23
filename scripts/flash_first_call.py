#!/usr/bin/env python3
"""The short first call on the GPU after a change to the flash kernel, its
log-sum-exp store or its backward.

    python3 scripts/flash_first_call.py

From the root of a checkout, on a machine with an NVIDIA Hopper card:
builds ``src/repro_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``, prints each instance's registers, spills and
shared memory, holds the bf16 forward against its plain version at small
shapes first (one tile, two tiles, ragged S, S = 1, every head-dim pair,
three Q/K panels at Dk 192) and then at the three prefill shapes, within
the reference's bf16 tolerance 2.5e-2.  Then the backward: the forward's
lse against a plain logsumexp and the backward kernel against
``flash_attention_bwd_ref`` (``chip_smoke.check_bwd_case``), small shapes
first (every pair of ``BWD_HEAD_DIMS``, f32 and bf16, causal and full;
bf16 within ``bwd_error``'s bound of the plain backward in f32) and then
tinyllama's training shape (B 8, S 2048, H 32, KV 4, D 64, bf16,
causal).  Times the prefill shapes and, at the training shape, the
forward with and without the lse store and the backward, back to back
with a warm L2 (mean of n calls between two CUDA events).  Exits non-zero
at the first case that fails; ``chip_smoke.py`` is the full run.
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
# the backward's (B, S, H, KV, Dk, Dv, causal), smallest first, every pair
# of BWD_HEAD_DIMS (one tile, two tiles, ragged S, S = 1, G up to 8); the
# training shape last (bf16 only)
BWD_CASES = [(1, 64, 1, 1, 64, 64, True), (1, 64, 1, 1, 64, 64, False),
             (1, 64, 1, 1, 128, 128, True), (1, 64, 1, 1, 192, 128, False),
             (1, 128, 2, 1, 64, 64, True), (2, 77, 4, 2, 16, 16, True),
             (2, 33, 4, 4, 24, 16, False), (3, 1, 4, 2, 64, 64, True),
             (1, 130, 8, 8, 96, 64, True), (1, 200, 8, 1, 64, 64, False),
             (2, 77, 6, 2, 128, 128, True), (1, 130, 6, 2, 128, 128, False),
             (2, 77, 4, 4, 192, 128, True), (1, 200, 8, 2, 192, 128, True),
             (3, 1, 4, 4, 192, 128, True), (1, 1024, 8, 1, 64, 64, True),
             (1, 1024, 24, 8, 128, 128, True),
             (1, 1024, 16, 16, 192, 128, True)]
TRAIN = (8, 2048, 32, 4, 64, 64, True)


def mean_ms(torch, fn, n) -> float:
    """Mean ms of n back-to-back calls between two CUDA events, after
    warm-up calls."""
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


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
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["flash_attention", "flash_attention_bwd"])
    chip_smoke.ptxas_report(build.build_log("flash_attention"), fa)
    chip_smoke.bwd_ptxas_report(build.build_log("flash_attention_bwd"), fa)
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
        ms = mean_ms(torch, lambda: fa.flash_attention(q, k, v), 50)
        print(f"  B={B} S={S} H={H} KV={KV} Dk={Dk} Dv={Dv} causal: "
              f"{ms:.4f} ms a call (back to back, L2 warm)")
    for i, case in enumerate(BWD_CASES + [TRAIN]):
        for dtype in ("float32", "bfloat16"):
            if case == TRAIN and dtype == "float32":
                continue
            # exits non-zero on a failed check
            err, frac = chip_smoke.check_bwd_case(torch, fa, case, dtype,
                                                  50 + i)
            print(f"  backward {dtype} {case}: dq/dk/dv max|diff| "
                  f"{err:.3e}, {frac:.3f} of the tolerance")
    B, S, H, KV, Dk, Dv, causal = TRAIN
    q, k, v = chip_smoke.flash_inputs(torch, B, S, H, KV, Dk, Dv,
                                      "bfloat16", 9)
    do = chip_smoke.flash_inputs(torch, B, S, H, KV, Dk, Dv, "bfloat16",
                                 10)[0]
    o, lse = fa._forward(q, k, v, causal, Dk ** -0.5, with_lse=True)
    for name, fn in (
            ("forward", lambda: fa._forward(q, k, v, causal, Dk ** -0.5,
                                            with_lse=False)),
            ("forward + lse", lambda: fa._forward(q, k, v, causal,
                                                  Dk ** -0.5, with_lse=True)),
            ("backward", lambda: fa.flash_attention_bwd(q, k, v, o, lse,
                                                        do))):
        print(f"  {name} B={B} S={S} H={H} KV={KV} D={Dk} bf16 causal: "
              f"{mean_ms(torch, fn, 10):.4f} ms a call (back to back, L2 "
              "warm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
