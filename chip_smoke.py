#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout: builds the CUDA kernels from
``src/repro_torch/csrc`` (printing the registers, spills and shared
memory of the bf16 flash kernel and of the paged kernels' body, which is
also built at the other chunk lengths timed below), holds each against
its plain PyTorch version (contexts across the paged kernels' chunk
edges and at the table's capacity, G = 3 and G = 7 at D = 128; the
attend-only kernel bitwise the fused one; the verify kernel bitwise
against chained decode-kernel launches, at windows across tile and chunk
edges, W = 1, width 0 on live tables, MQA with a lane's rows split over
blocks, and the 64-lane serving call; a lane alone bitwise among 64),
serves full-width tinyllama-1.1b (random bf16 weights from a seed) through
``ServeEngine`` under the gmg scheduler (fused and unfused attention,
one and four decode steps per call, equal token streams required),
probes whether results depend on batch grouping or prefill chunking,
holds full-width verify logits bitwise against decode logits, profiles
decode and verify forwards at contexts 48 and 240 and the temperature > 0
sampler, serves
speculative decoding (vllm and gmg, temperature 0 and 0.8; n-gram drafts
and drafts replayed from the plain run, which are accepted) with token
streams equal to plain decoding, serves the same workload on fleets of
full-width replicas through ``run_cluster`` (1 prefill + 1 decode under
the disagg router, with live KV migration, and 2 replicas under
slo-margin; merged streams equal to the colocated run's), holds a
migration's export/import bitwise (live and swapped out, bf16 pages as
int16 patterns on the host) beside ``migrate_time``'s price for it,
checks the paged kernels' ticket counters are zero after the fleets,
serves tensor-parallel (the ranks of one backend sharing the card, their
collectives through shared device buffers): the paged kernels at the
ranks' local heads, full-width tinyllama-1.1b in bf16 at tp=2 and tp=4
(gmg fused / four decode steps / unfused and vllm spec 0 / 4, equal
digests within each; the streams' first differences from tp=1's with
tp=1's top-2 logit gaps; the logits on identical pools; what sharing the
card costs a decode forward), a 1 prefill + 1 decode fleet at tp=2 (its
merged digest equal to the colocated tp=2 run's), full width cut to 2
layers in f32 at tp=1, 2 and 4 (equal digests), every rank's token hash
and ticket counters checked, profiles one decode dispatch of full-width
tinyllama-1.1b against the H100's roofline (``roofline_decode_step`` at
1, 8 and 64 live lanes, one dispatch and the window of 4 tokens; the
fused decode kernel reports its cost), runs deepseek-v2-lite-16b's MoE
layer at full width expert-parallel on ranks sharing the card (grids (1,
2), (1, 4) and (2, 2); 'weights' and decode 'tokens' modes, f32 and bf16)
against ``moe_ep_ref``, serves the MoE model kimi-k2 at full width
(its depth cut to one layer) through the same backend and workload (gmg
fused / unfused / four decode steps, vllm spec 0 / 4 / replayed drafts,
equal streams within each scheduler; batch invariance, verify logits
bitwise decode logits, the
decode forward's profile with the MoE's share, the memory a forward
takes beyond the resident tensors, the phase's peak memory; the paged
kernels are also checked at its heads, H=64, KV=8, D=128), and times the
kernels with CUDA events (the paged kernels also at chunk lengths 64,
128 and 256).
Then the full-sequence forward: the flash-attention kernel against its
plain version (the reference's sweep, ragged S, GQA groups of 3, MLA head
dims, every head-dim pair of the bf16 tensor-core body, deepseek-v2-lite's
Dk 192 / Dv 128) and its causal mask (K/V changed past a row leave it
bitwise equal), full-width tinyllama-1.1b, minicpm3-4b and
deepseek-v2-lite-16b (MLA + MoE; its f32 checks on its first 4 layers)
in f32 (``decode_step`` after ``prefill`` equal to ``logits``, one flash
launch per layer per forward, and for tinyllama the paged path's logits
equal too), the bf16 serving dtype at full depth through
``make_prefill_step`` / ``make_serve_step`` (8 greedy tokens, a profiled
prefill forward with the flash kernel's and the MoE's shares); the
recurrent and frontend families at full width, jamba-v0.1-52b (mamba +
attention + MoE, its depth cut to 16 of 32), xlstm-1.3b (mLSTM + sLSTM),
musicgen-medium (audio frames, sinusoidal positions) and pixtral-12b
(vision patches), each in f32 at a check depth (two ``decode_step``s
after ``prefill`` equal to ``logits``; each mamba, mLSTM and sLSTM layer
on the card equal to the CPU's), a bf16 gradient pass (every gradient
non-zero, a flash backward launch per attention layer) and its bf16 main
path (prefill and 8 greedy tokens through the step builders, a flash
launch per attention layer, profiled prefill and decode); and the flash
kernel's times at six prefill shapes (a kernel record at each family's).
Then training: the flash backward kernel against its plain version (every
head-dim pair of ``BWD_HEAD_DIMS``, S from 1 to 2048, causal and full, f32
and bf16, G = 1 and 8; bf16 at each family's gradient-pass shape; the
forward's log-sum-exp; two calls bitwise equal;
the bf16 wgmma body within ``fa.bwd_error``'s bound of the plain backward
in f32) and ``FlashAttentionFn`` against autograd through the plain
forward; an
f32 step of full-width tinyllama-1.1b cut to 2 layers on the card against
the CPU (loss and every gradient, each non-zero); the main path:
full-width tinyllama-1.1b in bf16 at B=8, S=2048 with remat and AdamW,
10 steps through ``make_accum_train_step`` (the loss must fall; step time,
tokens/s, model TFLOP/s, peak memory, flash launches per step, one
profiled step), its bf16 witness and the same steps through the plain
attention; the restart drill (``TrainSupervisor.run_with_recovery`` in
f32, depth cut to 1: one restart, final params equal to the clean run's);
bf16 training at full width, depth cut to 2, of minitron-4b (Dh 128) and
deepseek-v2-lite-16b (MLA, Dk 192, Dv 128): every gradient non-zero, the
witness, two AdamW steps, the backward at each model's attention shape
timed; and the backward's and the training-shape forward's times.
Prints the card, the checks, one JSON line of kernel records and,
last, one JSON line naming the device.  Exits non-zero, with no result
lines, on any failed check, when CUDA is unavailable, or outside a checkout.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 on the tensor cores
SOURCE = "src/repro_torch/csrc/paged_attention.cu"
REPLACES = {"fused_decode_attention": "src/repro/kernels/paged_attention.py:147",
            "paged_attention": "src/repro/kernels/paged_attention.py:462",
            "fused_verify_attention": "src/repro/kernels/paged_attention.py:290"}
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:64"
BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
# the backward replaces no pallas_call: it is the port's counterpart of the
# gradient XLA takes of the reference's training attention, online_attention
BWD_REPLACES = "src/repro/models/attention.py:34"
# training: the main path's model, (B, S) (S: TinyLlama's pretraining
# length), steps and learning rate; the depths the f32 card-vs-CPU step and
# the restart drill cut it to (full width)
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_SHAPE = (8, 2048)
TRAIN_STEPS = 10
TRAIN_LR = 3e-4
CHECK_LAYERS = 2
DRILL_LAYERS = 1
# bf16 training at full width on the flash backward's other full-width head
# dims, depth cut to 2 (deepseek: its dense first layer and one MoE layer;
# AdamW's f32 moments at full depth outgrow one card): minitron-4b (GQA,
# Dh 128, G = 3) and deepseek-v2-lite-16b (MLA, Dk 192, Dv 128); (B, S),
# and the AdamW steps each takes after its gradient pass
WIDE_TRAIN = ("minitron-4b", "deepseek-v2-lite-16b")
WIDE_LAYERS = 2
WIDE_SHAPE = (2, 2048)
WIDE_STEPS = 2
# the backward kernel's sweep lengths; its tolerances against the plain
# version are ``BWD_F32_RTOL`` and the bf16 bound of ``fa.bwd_error``
# (src/repro_torch/kernels/flash_attention.py, derived beside the
# constants)
BWD_S = (1, 63, 65, 200, 1024, 2048)
# the backward at the families' gradient passes (bf16, causal; B=1):
# (B, S, H, KV, Dk, Dv) of jamba (S 256) and pixtral (1024 patches + 256
# tokens), G = 4 at D 128, and of musicgen (MHA, D 64)
FLASH_FAMILY_BWD = [(1, 256, 32, 8, 128, 128), (1, 1280, 32, 8, 128, 128),
                    (1, 256, 24, 24, 64, 64)]
# card-vs-CPU f32 gradients: max |difference| over each leaf's largest CPU
# value (sums over d = 2048 / 5632 and 512 tokens in other orders)
TRAIN_GRAD_RTOL = 1e-4
# the bf16 witness at full width and depth: the kernels' gradients against
# autograd through the plain attention on the same weights and batch, max
# |difference| over each leaf's largest plain value.  A bf16 ulp is 2^-8
# of the value; the kernel rounds P to bf16 before P.V and the two paths'
# bf16 activations then round apart in each of the 22 layers, so 5e-2;
# a lost or mis-scaled term moves a gradient by the order of its size.
# The losses within 1e-3 of the plain one (f32 sums of bf16 logits' inputs)
BF16_GRAD_RTOL = 5e-2
BF16_LOSS_RTOL = 1e-3
# the full-sequence models: (B, S) of the f32 checks and of the bf16 runs
FULLSEQ = {"tinyllama-1.1b": ((4, 512), (4, 1024)),
           "minicpm3-4b": ((2, 256), (2, 1024)),
           "deepseek-v2-lite-16b": ((2, 256), (2, 1024))}
# depth of the f32 checks where the full depth does not fit in f32 beside
# the bf16 weights: deepseek-v2-lite's 27 layers take about 63 GB in f32,
# 4 (its dense layer and 3 MoE layers) about 8.5 GB
F32_LAYERS = {"deepseek-v2-lite-16b": 4}
GREEDY_STEPS = 8
# the recurrent and frontend families at full width: (B, S) of the bf16
# main path, its depth, the depth of the f32 checks and of the bf16
# gradient pass, and (B, S) of the f32 checks (the gradient pass: B=1 at
# the same S).  jamba is CUT to 16 of 32 layers (2 of 4 units: 48.5 GiB in
# bf16; all 32 take 96.1 GiB), its f32 checks to one unit (8 layers, 49.5
# GiB, drawn on their own: they do not fit beside the bf16 weights);
# pixtral's f32 checks to its first 4 layers (9.1 GiB).  xlstm's S = 2048 is
# two of the mLSTM's 1024-key chunks, so the online merge runs; pixtral's
# sequences are 1024 patches and the text after them
RECURRENT = {"jamba-v0.1-52b": ((2, 1024), 16, 8, (2, 256)),
             "xlstm-1.3b": ((2, 2048), 48, 48, (2, 256)),
             "musicgen-medium": ((4, 1024), 48, 48, (2, 256)),
             "pixtral-12b": ((2, 2048), 40, 4, (2, 1280))}
# one mixer on the card against the CPU (f32, TF32 off, B=1, S=256, the
# same weights and input): max |difference| over the tensor's largest CPU
# value (sums over d = 4096 or 2048 in other orders, then a 256-step
# recurrence)
MIXER_RTOL = 1e-4
# the MoE model served through the paged path, at full width and cut depth:
# at depth 1 its 384 experts take 33.8 GB, attention 0.26 GB, embed and
# lm_head 4.7 GB and the lm_head's f32 copy 4.7 GB, about 43.5 GB; depth 2
# would take about 78 GB, beyond an 80 GB card with the pools and the
# activations
KIMI = "kimi-k2-1t-a32b"
KIMI_LAYERS = 1
# depth of the f32 tensor-parallel runs (tp=1, 2 and 4 give equal streams)
TP_F32_LAYERS = 2
# the flash kernel's cases: (B, S, H, KV, Dk, Dv, dtype, causal)
FLASH_SWEEP = [(B, S, H, KV, D, D, dt, True)          # the reference sweep
               for B, S, H, KV, D in ((2, 128, 4, 4, 64), (1, 256, 8, 2, 64),
                                      (2, 256, 4, 1, 128),
                                      (1, 512, 8, 8, 128))
               for dt in ("float32", "bfloat16")] + [
    (1, 128, 4, 4, 64, 64, "float32", False),         # non-causal
    (2, 77, 32, 4, 64, 64, "float32", True),          # ragged S
    (1, 1000, 8, 2, 64, 64, "bfloat16", True),
    (1, 1000, 8, 2, 64, 64, "float32", False),
    (1, 300, 24, 8, 128, 128, "float32", True),       # G = 3 at D = 128
    (1, 300, 24, 8, 128, 128, "bfloat16", True),
    (2, 256, 40, 40, 96, 64, "float32", True),        # MHA, Dk 96, Dv 64
    (2, 256, 40, 40, 96, 64, "bfloat16", True),
    # the bf16 body at the other head-dim pairs it is built for (head dims
    # padded to 64-wide panels), ragged S, S = 1 and non-causal
    (2, 77, 8, 2, 16, 16, "bfloat16", True),          # reduced GQA dims
    (2, 33, 4, 4, 24, 16, "bfloat16", False),         # reduced MLA dims
    (3, 1, 8, 2, 64, 128, "bfloat16", True),          # S = 1
    (1, 200, 8, 1, 64, 128, "bfloat16", False),
    (1, 130, 24, 8, 96, 128, "bfloat16", True),
    (1, 1, 6, 2, 96, 128, "bfloat16", False),
    (2, 300, 24, 8, 128, 64, "bfloat16", False),
    (1, 1000, 16, 2, 16, 16, "bfloat16", False),
    # deepseek-v2-lite's MLA head dims (three Q/K panels), causal and full,
    # ragged S, G = 1 and G = 4
    (1, 300, 16, 16, 192, 128, "float32", True),
    (2, 77, 16, 16, 192, 128, "float32", False),
    (2, 77, 16, 16, 192, 128, "bfloat16", True),
    (1, 200, 16, 16, 192, 128, "bfloat16", False),
    (1, 1000, 8, 2, 192, 128, "bfloat16", True),
    (3, 1, 16, 16, 192, 128, "bfloat16", True)]
# the main path's calls: each model's bf16 prefill and f32 check
FLASH_MAIN = [(4, 1024, 32, 4, 64, 64, "bfloat16", True),
              (2, 1024, 40, 40, 96, 64, "bfloat16", True),
              (2, 1024, 16, 16, 192, 128, "bfloat16", True),
              (4, 512, 32, 4, 64, 64, "float32", True),
              (2, 256, 40, 40, 96, 64, "float32", True),
              (2, 256, 16, 16, 192, 128, "float32", True)]
# the recurrent and frontend families' attention shapes: each family's
# bf16 main path (its kernel record's shape), then the f32 checks'
# (musicgen MHA at D 64; pixtral and jamba G = 4 at D 128)
FLASH_FAMILY = {"musicgen-medium": (4, 1024, 24, 24, 64, 64),
                "pixtral-12b": (2, 2048, 32, 8, 128, 128),
                "jamba-v0.1-52b": (2, 1024, 32, 8, 128, 128)}
FLASH_FAMILY_F32 = [(2, 256, 24, 24, 64, 64, "float32", True),
                    (2, 1280, 32, 8, 128, 128, "float32", True),
                    (2, 256, 32, 8, 128, 128, "float32", True)]
# the capped mixed workload of the quickstart's real-execution mode
WORKLOAD = dict(rate=1.5, duration=6.0, seed=0, mix=(2, 1, 1), prompt_cap=40,
                output_cap=12, slo_scale=20.0)
# the paged kernels' chunk lengths (tokens a block covers) timed side by side
CHUNKS = (64, 128, 256)
# the backend of every serving run, a fleet's replicas included
SERVE_KW = dict(arch="tinyllama-1.1b", reduced=False, num_blocks=512, page=16,
                max_len=256, seed=0)
# prompt of every third request in the speculative runs: random prompts
# give the n-gram drafter nothing to match
MOTIF = [11, 42, 7, 99]


def motif_prompts(req):
    """``ExperimentSpec.prompts`` of the speculative runs: every third rid's
    prompt repeats ``MOTIF``, the rest are the backend's random ones."""
    if req.rid % 3:
        return None
    return (MOTIF * req.prompt_len)[:req.prompt_len]


class ReplayDrafter:
    """Drafts a finished run's streams back: for a history that is a prefix
    of a recorded prompt + output, it proposes what followed.  Replaying
    the plain run that a speculative run must equal makes the drafts the
    target's own tokens, so they are accepted: the multi-token emit, the
    remaining-output clamp and later steps reading accepted rows' KV run."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, tokens, k):
        hist = [int(t) for t in tokens]
        n = len(hist)
        for s in self.streams:
            if len(s) > n and s[:n] == hist:
                return s[n:n + k]
        return []


def replay_of(be, prompts):
    """A ``ReplayDrafter`` of the run ``be`` just served: prompt + output
    of every single request of the workload (DAG stages get no drafts)."""
    from repro_torch.serving.workload import WorkloadGen, WorkloadSpec

    singles, _ = WorkloadGen(WorkloadSpec(**WORKLOAD)).generate()
    streams = []
    for r in singles:
        toks = prompts(r) if prompts else None
        if toks is not None:
            r.meta["prompt_tokens"] = list(toks)
        streams.append([int(t) for t in be.prompt_ids(r)]
                       + list(be.generated.get(r.rid, [])))
    return ReplayDrafter(streams)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def case(torch, B, H, KV, D, page, ctxs, dtype, seed):
    """Random pools, disjoint shuffled block tables and new K/V rows on the
    card; pool index P-1 is the scrap page no table names."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_max = max(-(-c // page) for c in ctxs)
    P = B * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    tables = torch.randperm(P - 1, generator=g, device="cuda")
    return dict(q=rnd(B, H, D), k_new=rnd(B, KV, D), v_new=rnd(B, KV, D),
                k_pages=rnd(P, page, KV, D), v_pages=rnd(P, page, KV, D),
                tables=tables.reshape(B, n_max).to(torch.int32),
                ctx=torch.tensor(ctxs, dtype=torch.int32, device="cuda"))


def serving_case(torch, B, ctxs, seed, H=32, KV=4, D=64):
    """The decode call the serving path makes at full width: B lanes, the
    first len(ctxs) live at those contexts on a padded table (pages past
    the context name the scrap page), the rest padding lanes at position 0
    on the all-scrap table.  n_max 16 (max_len 256), bf16; tinyllama's
    heads by default."""
    page, n_max = 16, 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = len(ctxs) * n_max + 1
    scrap = P - 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    pages = torch.randperm(P - 1, generator=g, device="cuda").to(torch.int32)
    tables = torch.full((B, n_max), scrap, dtype=torch.int32, device="cuda")
    ctx = torch.ones(B, dtype=torch.int32, device="cuda")
    for i, c in enumerate(ctxs):
        used = -(-c // page)
        tables[i, :used] = pages[i * n_max:i * n_max + used]
        ctx[i] = c
    return dict(q=rnd(B, H, D), k_new=rnd(B, KV, D), v_new=rnd(B, KV, D),
                k_pages=rnd(P, page, KV, D), v_pages=rnd(P, page, KV, D),
                tables=tables, ctx=ctx)


def check_kernels(torch, pa, c, atol, label, live=None):
    """Both decode kernels against their plain versions on one case, and
    ``paged_attention`` bitwise ``fused_decode_attention`` on the pools
    that one wrote; returns each kernel's largest output difference.  The
    fused kernel's outputs are compared on the first ``live`` lanes only
    (default all): padding lanes all write and read the scrap page's slot 0
    at once, so theirs are whatever row won.  In bf16 both sides compute
    in f32 and round once, so besides ``atol`` every element must lie
    within one bf16 ulp of the plain version's (|diff| <= 2^-7 |plain| +
    1e-5): at context 512 one dropped token moves an output by about 2e-3,
    past that limit, where ``atol`` alone would not notice it."""
    out_k = pa.paged_attention(c["q"], c["k_pages"], c["v_pages"],
                               c["tables"], c["ctx"])
    out_p = pa.paged_attention_ref(c["q"], c["k_pages"], c["v_pages"],
                                   c["tables"], c["ctx"])
    pos = c["ctx"] - 1
    kk, vk = c["k_pages"].clone(), c["v_pages"].clone()
    kr, vr = c["k_pages"].clone(), c["v_pages"].clone()
    fo_k, kk, vk = pa.fused_decode_attention(c["q"], c["k_new"], c["v_new"],
                                             kk, vk, c["tables"], pos)
    fo_p, kr, vr = pa.fused_decode_attention_ref(
        c["q"], c["k_new"], c["v_new"], kr, vr, c["tables"], pos)
    # the attend-only kernel on the pools the fused one wrote: bitwise
    out_a = pa.paged_attention(c["q"], kk, vk, c["tables"], c["ctx"])
    torch.cuda.synchronize()
    pools_equal = bool(torch.equal(kk[:-1], kr[:-1])
                       and torch.equal(vk[:-1], vr[:-1]))
    same = bool(torch.equal(out_a[:live], fo_k[:live]))
    errs = {}
    for name, k, p in (("paged_attention", out_k, out_p),
                       ("fused_decode_attention", fo_k[:live], fo_p[:live])):
        diff = (k.float() - p.float()).abs()
        errs[name] = diff.max().item()
        check(errs[name] <= atol, f"{name} {label}: {errs[name]} > {atol}")
        if p.dtype == torch.bfloat16:
            check(bool((diff <= 2.0 ** -7 * p.float().abs() + 1e-5).all()),
                  f"{name} {label}: more than one bf16 ulp off")
    print(f"  {label}: paged_attention max|diff| "
          f"{errs['paged_attention']:.3e}, fused_decode_attention max|diff| "
          f"{errs['fused_decode_attention']:.3e}, pools equal off the scrap "
          f"page: {pools_equal}, paged_attention bitwise "
          f"fused_decode_attention: {same}")
    check(pools_equal, f"fused_decode_attention {label}: pools differ")
    check(same, f"paged_attention {label}: differs from "
          "fused_decode_attention on the pools it wrote")
    return errs


def verify_case(torch, B, W, H, KV, D, page, ctxs, widths, dtype, seed,
                lanes=None):
    """A speculative-verification call on the card: ``lanes`` lanes
    (default B), the first B live with row 0 at context ``ctxs[b]`` (pos0 =
    ctx - 1) and ``widths[b]`` live rows, on disjoint shuffled pages with
    room for the window; the rest padding lanes at width 0 on the
    all-scrap table.  Pool index P-1 is the scrap page."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lanes = lanes or B
    n_max = max(-(-(c + W) // page) for c in ctxs)
    P = B * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    tables = torch.full((lanes, n_max), P - 1, dtype=torch.int32,
                        device="cuda")
    tables[:B] = torch.randperm(P - 1, generator=g, device="cuda").reshape(
        B, n_max).to(torch.int32)
    pos0 = torch.zeros(lanes, dtype=torch.int32, device="cuda")
    pos0[:B] = torch.tensor(ctxs, dtype=torch.int32, device="cuda") - 1
    wid = torch.zeros(lanes, dtype=torch.int32, device="cuda")
    wid[:B] = torch.tensor(widths, dtype=torch.int32, device="cuda")
    return dict(q=rnd(lanes, W, H, D), k_new=rnd(lanes, W, KV, D),
                v_new=rnd(lanes, W, KV, D), k_pages=rnd(P, page, KV, D),
                v_pages=rnd(P, page, KV, D), tables=tables, pos0=pos0,
                widths=wid)


def check_verify(torch, pa, c, atol, label) -> float:
    """``fused_verify_attention`` against its plain version (W chained
    plain decode steps) and against W chained launches of the
    ``fused_decode_attention`` kernel, on the live rows (s < width) of one
    case: within ``atol`` and one bf16 ulp of the plain version, bitwise
    equal to the chained kernel, pools equal to both off the scrap page.
    Returns the largest output difference from the plain version."""
    args = (c["q"], c["k_new"], c["v_new"])
    tab, pos0, wid = c["tables"], c["pos0"], c["widths"]
    pools = [(c["k_pages"].clone(), c["v_pages"].clone()) for _ in range(3)]
    o_k, kk, vk = pa.fused_verify_attention(*args, *pools[0], tab, pos0, wid)
    o_p, kp, vp = pa.fused_verify_attention_ref(*args, *pools[1], tab, pos0,
                                                wid)
    kc, vc = pools[2]
    scrap = torch.full_like(tab, c["k_pages"].shape[0] - 1)
    chained = []
    for s in range(c["q"].shape[1]):
        tab_s = torch.where(wid[:, None] > s, tab, scrap)
        o, kc, vc = pa.fused_decode_attention(
            *(a[:, s].contiguous() for a in args), kc, vc, tab_s, pos0 + s)
        chained.append(o)
    o_c = torch.stack(chained, dim=1)
    torch.cuda.synchronize()
    live = (torch.arange(c["q"].shape[1], device="cuda")[None, :]
            < wid[:, None])
    diff = (o_k[live].float() - o_p[live].float()).abs()
    err = diff.max().item()
    check(err <= atol, f"fused_verify_attention {label}: {err} > {atol}")
    if o_p.dtype == torch.bfloat16:
        check(bool((diff <= 2.0 ** -7 * o_p[live].float().abs()
                    + 1e-5).all()),
              f"fused_verify_attention {label}: more than one bf16 ulp off")
    same = bool(torch.equal(o_k[live], o_c[live]))
    pools_equal = all(torch.equal(a[:-1], b[:-1]) for a, b in
                      ((kk, kp), (vk, vp), (kk, kc), (vk, vc)))
    print(f"  {label}: fused_verify_attention max|diff| {err:.3e}, bitwise "
          f"equal to chained fused_decode_attention: {same}, pools equal "
          f"off the scrap page: {pools_equal}")
    check(same, f"fused_verify_attention {label}: live rows differ from "
          "chained fused_decode_attention launches")
    check(pools_equal, f"fused_verify_attention {label}: pools differ")
    return err


VERIFY_MAIN = [  # (B, W, row-0 contexts, widths): bf16, H=32 KV=4 D=64
    (1, 2, [511], [2]), (1, 5, [508], [5]), (1, 9, [504], [9]),
    (8, 2, [1, 15, 16, 17, 100, 256, 500, 510], [2, 1, 2, 2, 1, 2, 2, 2]),
    (8, 5, [1, 12, 16, 17, 100, 256, 500, 508], [5, 1, 3, 5, 2, 5, 4, 5]),
    (8, 9, [1, 8, 16, 17, 100, 250, 497, 504], [9, 1, 9, 5, 9, 2, 7, 9]),
    # windows across a 64-token tile edge: rows at ctx 62-66 and 125-133
    (2, 5, [62, 60], [5, 5]), (2, 9, [125, 120], [9, 9]),
    (4, 1, [1, 64, 65, 300], [1, 1, 1, 1]),                     # W = 1
    (4, 5, [20, 64, 100, 200], [0, 5, 0, 3])]   # width 0 on live tables
VERIFY_SWEEP = [  # (B, W, H, KV, D, page, contexts, widths, dtype)
    (3, 3, 6, 3, 64, 16, [1, 40, 200], [3, 1, 2], "float32"),  # G = 2
    (2, 4, 8, 1, 128, 16, [77, 300], [4, 3], "float32"),  # MQA, D=128
    (2, 5, 16, 4, 16, 8, [5, 60], [5, 2], "float32"),     # D=16, page 8
    (2, 2, 8, 2, 128, 16, [127, 128], [2, 2], "float32"),  # page edge
    # MQA at W = 9: 288 tasks per lane, split over 9 blocks of 32
    (2, 9, 32, 1, 128, 16, [120, 250], [9, 7], "float32"),
    (2, 9, 32, 1, 128, 16, [60, 250], [9, 6], "bfloat16"),
    (2, 9, 8, 8, 64, 16, [60, 100], [9, 4], "bfloat16"),  # G = 1
    # rows of 24 bytes, not whole 16-byte units: the plain-copy body
    (2, 3, 4, 2, 12, 8, [30, 70], [3, 2], "bfloat16")]


def check_verify_all(torch, pa) -> float:
    """Every verify-kernel case; returns the largest error at the main
    path's shapes (bf16, full width)."""
    worst = 0.0
    for B, W, ctxs, widths in VERIFY_MAIN:
        c = verify_case(torch, B, W, 32, 4, 64, 16, ctxs, widths,
                        torch.bfloat16, seed=300 + 10 * B + W)
        worst = max(worst, check_verify(
            torch, pa, c, 2e-2, f"bf16 B={B} W={W} H=32 KV=4 D=64 "
            f"ctx<={max(ctxs) + W - 1} widths {widths}"))
    # the serving path's verify calls: 64 lanes, 8 drafted lanes at
    # contexts across page edges up to 52, 56 padding lanes at width 0
    for W, widths in ((5, [5, 2, 5, 1, 4, 5, 3, 5]),
                      (9, [9, 2, 9, 1, 4, 9, 3, 9])):
        c = verify_case(torch, 8, W, 32, 4, 64, 16,
                        [1, 15, 16, 17, 32, 33, 48, 52], widths,
                        torch.bfloat16, seed=400 + W - 5, lanes=64)
        worst = max(worst, check_verify(
            torch, pa, c, 2e-2, f"bf16 64 lanes (8 live, ctx<={51 + W}) "
            f"W={W} H=32 KV=4 D=64"))
    for i, (B, W, H, KV, D, page, ctxs, widths, dt) in enumerate(
            VERIFY_SWEEP):
        dtype = getattr(torch, dt)
        c = verify_case(torch, B, W, H, KV, D, page, ctxs, widths, dtype,
                        seed=500 + i)
        per, groups, chunks, _, _ = pa.blocking(
            W, H // KV, D, dtype.itemsize, c["tables"].shape[1], page)
        check_verify(torch, pa, c, 1e-5 if dt == "float32" else 2e-2,
                     f"{dt} B={B} W={W} H={H} KV={KV} D={D} page={page} "
                     f"({groups} groups of {per} tasks x {chunks} chunks "
                     "per lane and kv-head)")
    # windows across chunk edges, one straddling each, the last row one
    # token short of the table's capacity; G = 3 and G = 7 at D = 128
    C = pa.CHUNK
    for i, (B, W, H, KV, D, ctxs, widths, dt) in enumerate((
            (4, 5, 32, 4, 64, [C - 2, C + 1, 2 * C - 3, 4 * C - 4],
             [5, 5, 5, 5], "bfloat16"),
            (3, 9, 32, 4, 64, [C - 8, 2 * C - 1, 3 * C - 4], [9, 9, 9],
             "bfloat16"),
            (2, 4, 24, 8, 128, [C - 1, 2 * C + 1], [4, 3], "float32"),
            (2, 4, 24, 8, 128, [C - 1, 2 * C + 1], [4, 3], "bfloat16"),
            (2, 3, 56, 8, 128, [C, 3 * C - 2], [3, 3], "float32"),
            (2, 3, 56, 8, 128, [C, 3 * C - 2], [3, 3], "bfloat16"))):
        dtype = getattr(torch, dt)
        c = verify_case(torch, B, W, H, KV, D, 16, ctxs, widths, dtype,
                        seed=550 + i)
        err = check_verify(torch, pa, c, 1e-5 if dt == "float32" else 2e-2,
                           f"{dt} B={B} W={W} H={H} KV={KV} D={D} "
                           f"ctx {ctxs[0]}..{max(ctxs) + W - 1} across "
                           f"{C}-token chunk edges")
        if (H, KV, D, dt) == (32, 4, 64, "bfloat16"):
            worst = max(worst, err)
    return worst


def lane_alone(torch, pa) -> None:
    """A lane's outputs do not depend on the lanes beside it: each live
    lane of a 64-lane serving call (8 live at contexts across chunk edges
    up to the table's capacity, 56 padding lanes) bitwise equal to the same
    lane in a call of its own, for all three kernels (the verify kernel at
    W=5 on 64 lanes, 8 drafted)."""
    C = pa.CHUNK
    ctxs = [min(x, 256) for x in (1, C - 1, C, C + 1, 2 * C - 1, 2 * C, 200,
                                  251)]
    c = serving_case(torch, 64, ctxs, seed=260)
    pos = c["ctx"] - 1
    kk, vk = c["k_pages"].clone(), c["v_pages"].clone()
    together, _, _ = pa.fused_decode_attention(
        c["q"], c["k_new"], c["v_new"], kk, vk, c["tables"], pos)
    att = pa.paged_attention(c["q"], c["k_pages"], c["v_pages"], c["tables"],
                             c["ctx"])
    v = verify_case(torch, 8, 5, 32, 4, 64, 16, [x + 1 for x in ctxs],
                    [5, 1, 5, 3, 5, 2, 4, 5], torch.bfloat16, seed=261,
                    lanes=64)
    vt, _, _ = pa.fused_verify_attention(
        v["q"], v["k_new"], v["v_new"], v["k_pages"].clone(),
        v["v_pages"].clone(), v["tables"], v["pos0"], v["widths"])
    same = 0
    for i in range(len(ctxs)):
        one = slice(i, i + 1)
        k1, v1 = c["k_pages"].clone(), c["v_pages"].clone()
        o1, _, _ = pa.fused_decode_attention(
            c["q"][one], c["k_new"][one], c["v_new"][one], k1, v1,
            c["tables"][one], pos[one])
        a1 = pa.paged_attention(c["q"][one], c["k_pages"], c["v_pages"],
                                c["tables"][one], c["ctx"][one])
        w = int(v["widths"][i])
        r1, _, _ = pa.fused_verify_attention(
            v["q"][one], v["k_new"][one], v["v_new"][one],
            v["k_pages"].clone(), v["v_pages"].clone(), v["tables"][one],
            v["pos0"][one], v["widths"][one])
        same += (torch.equal(o1[0], together[i]) + torch.equal(a1[0], att[i])
                 + torch.equal(r1[0, :w], vt[i, :w]))
    torch.cuda.synchronize()
    print(f"  a lane alone vs among 64 (8 live at ctx {ctxs}): "
          f"{same}/{3 * len(ctxs)} bitwise equal (fused decode, attend only, "
          "verify W=5)")
    check(same == 3 * len(ctxs), "a lane's outputs depend on the lanes "
          "beside it")


def check_paged_all(torch, pa) -> dict:
    """Every check of the three paged kernels: each against its plain
    version (bf16 main and serving shapes, contexts across chunk edges and
    at the table's capacity, f32 sweeps with G = 3 and G = 7 at D = 128),
    ``paged_attention`` bitwise ``fused_decode_attention``, every verify
    case bitwise chained decode launches, a lane alone bitwise among 64.
    Returns each kernel's largest error at the main path's shapes."""
    print(f"paged kernels vs plain versions ({pa.CHUNK}-token chunks):")
    main_err = dict.fromkeys(pa.launches, 0.0)   # at the main path's shapes
    C = pa.CHUNK
    main_ctxs = {1: [512], 8: [1, 15, 16, 17, 100, 256, 511, 512],
                 # chunk edges, the last at the table's capacity (4 chunks)
                 9: [C - 1, C, C + 1, 2 * C - 1, 2 * C + 1, 3 * C,
                     4 * C - 65, 4 * C - 1, 4 * C]}
    for B, ctxs in main_ctxs.items():
        c = case(torch, B, 32, 4, 64, 16, ctxs, torch.bfloat16, seed=B)
        errs = check_kernels(torch, pa, c, 2e-2,
                             f"bf16 B={B} H=32 KV=4 D=64 ctx<={max(ctxs)}")
        main_err.update({k: max(main_err[k], v) for k, v in errs.items()})
    # the serving path's own call shapes: 8 live lanes at contexts across
    # page and chunk edges, beside padding lanes on the all-scrap table (a
    # batch of 5 pads to 8 lanes; 64 lanes is the widest padding checked)
    edges = [min(x, 256) for x in (C - 1, C, C + 1, 2 * C - 1, 2 * C, 240,
                                   255, 256)]      # capacity 256
    for B, live, ctxs, seed in ((8, 5, [1, 15, 16, 17, 32], 213),
                                (8, 8, [1, 15, 16, 17, 32, 33, 48, 52], 216),
                                (64, 8, [1, 15, 16, 17, 32, 33, 48, 52], 272),
                                (64, 8, edges, 290)):
        c = serving_case(torch, B, ctxs, seed=seed)
        errs = check_kernels(torch, pa, c, 2e-2,
                             f"bf16 B={B} ({live} live, ctx<={max(ctxs)}) "
                             f"H=32 KV=4 D=64 n_max=16", live=live)
        main_err.update({k: max(main_err[k], v) for k, v in errs.items()})
    sweep = [(3, 6, 3, 64, 16, [1, 40, 200]),       # GQA, heads not 2^k
             (2, 8, 1, 128, 16, [77, 300]),         # MQA, D=128
             (2, 16, 4, 16, 8, [5, 64]),            # D=16, page 8
             (2, 8, 2, 128, 16, [128, 129]),        # D=128, page edge
             (4, 24, 8, 128, 16, [1, C, C + 1, 3 * C]),     # G = 3
             (4, 56, 8, 128, 16, [C - 1, 2 * C, 2 * C + 1, 300])]  # G = 7
    for i, (B, H, KV, D, page, ctxs) in enumerate(sweep):
        for dt, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
            if dt == "bfloat16" and KV != 8:
                continue                          # bf16 at G = 3 and 7 only
            c = case(torch, B, H, KV, D, page, ctxs, getattr(torch, dt),
                     seed=100 + i)
            check_kernels(torch, pa, c, tol,
                          f"{dt} B={B} H={H} KV={KV} D={D} page={page} "
                          f"ctx {ctxs}")
    main_err["fused_verify_attention"] = check_verify_all(torch, pa)
    # kimi-k2's serving calls (H=64, KV=8, D=128): decode and attend only
    # with 8 live of 64 lanes, and the verify kernel at W=5, 8 drafted
    # lanes beside 56 padding lanes
    live = [1, 15, 16, 17, 32, 33, 48, 52]
    c = serving_case(torch, 64, live, seed=295, H=64, KV=8, D=128)
    errs = check_kernels(torch, pa, c, 2e-2, "bf16 B=64 (8 live, "
                         "ctx<=52) H=64 KV=8 D=128 n_max=16 (kimi-k2)",
                         live=8)
    main_err.update({k: max(main_err[k], v) for k, v in errs.items()})
    c = verify_case(torch, 8, 5, 64, 8, 128, 16, live,
                    [5, 2, 5, 1, 4, 5, 3, 5], torch.bfloat16, seed=296,
                    lanes=64)
    main_err["fused_verify_attention"] = max(
        main_err["fused_verify_attention"],
        check_verify(torch, pa, c, 2e-2, "bf16 64 lanes (8 live, ctx<=56) "
                     "W=5 H=64 KV=8 D=128 (kimi-k2)"))
    lane_alone(torch, pa)
    return main_err


def median_ms(torch, fn, flush, reps=30):
    """Median device time of one call from CUDA events, with the L2 cache
    flushed before every call (the decode step walks 22 layers of pools,
    so a kernel finds its pages cold).  A spin kernel ahead of each call
    keeps the device busy while the host enqueues it, so the events time
    the device work and not the wrapper's Python."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def chunk_defines(chunk, default):
    """nvcc defines of the paged kernels' build at ``chunk``-token chunks:
    none at the wrapper's own ``CHUNK``."""
    return () if chunk == default else (f"REPRO_CHUNK={chunk}",)


def build_all(build, libs, default):
    """Build ``libs`` and the paged kernels at every other chunk length of
    ``CHUNKS``, one ``nvcc`` for each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(libs, ())] + [(["paged_attention"], chunk_defines(c, default))
                           for c in CHUNKS if c != default]
    with ThreadPoolExecutor(len(jobs)) as ex:
        for f in [ex.submit(build.build, n, d) for n, d in jobs]:
            f.result()


def use_chunk(pa, build, chunk, default):
    """Point the paged wrappers at the library built with ``chunk``-token
    chunks (``default``: the wrapper's own)."""
    pa.CHUNK = chunk
    pa._lib = pa._bind(build.load("paged_attention",
                                  chunk_defines(chunk, default)))


def paged_calls(torch, pa):
    """The paged kernels' timed calls, {label: fn}, bf16, H=32, KV=4, D=64,
    page 16: at the timing shape (B=8, ctx 512) the two decode kernels, the
    verify kernel at W=1 and W=5 (the last row at ctx 512) and with every
    width 0 (each block exits at once: the launch's floor); the fused decode
    kernel and the verify kernel at W=1 at contexts 64, 128 and 256; at the
    serving shape (64 lanes, 8 live at ctx 240, n_max 16) the two decode
    kernels and the verify kernel at W=1 and W=5."""
    B, H, KV, D, page, W = 8, 32, 4, 64, 16, 5
    bf = torch.bfloat16
    names = ("q", "k_new", "v_new", "k_pages", "v_pages", "tables", "pos0",
             "widths")
    out = {}

    def decode(label, c, attend=True):
        pos = c["ctx"] - 1
        out[f"fused_decode_attention {label}"] = lambda: \
            pa.fused_decode_attention(c["q"], c["k_new"], c["v_new"],
                                      c["k_pages"], c["v_pages"],
                                      c["tables"], pos)
        if attend:
            out[f"paged_attention {label}"] = lambda: pa.paged_attention(
                c["q"], c["k_pages"], c["v_pages"], c["tables"], c["ctx"])

    def verify(label, v):
        out[f"fused_verify_attention {label}"] = lambda: \
            pa.fused_verify_attention(*(v[k] for k in names))

    decode("ctx 512", case(torch, B, H, KV, D, page, [512] * B, bf, seed=7))
    verify("W=1 ctx 512", verify_case(torch, B, 1, H, KV, D, page,
                                      [512] * B, [1] * B, bf, seed=8))
    for w in (W, 0):
        verify(f"W={W} ctx 512" + (" widths 0" if w == 0 else ""),
               verify_case(torch, B, W, H, KV, D, page, [512 - W + 1] * B,
                           [w] * B, bf, seed=8))
    for ctx in (64, 128, 256):
        decode(f"ctx {ctx}", case(torch, B, H, KV, D, page, [ctx] * B, bf,
                                  seed=7), attend=False)
        verify(f"W=1 ctx {ctx}", verify_case(torch, B, 1, H, KV, D, page,
                                             [ctx] * B, [1] * B, bf, seed=8))
    serving = "serving (64 lanes, 8 live at ctx 240)"
    decode(serving, serving_case(torch, 64, [240] * 8, seed=9))
    for w in (1, W):
        verify(f"W={w} {serving}", verify_case(
            torch, 8, w, H, KV, D, page, [240] * 8, [w] * 8, bf, seed=10,
            lanes=64))
    return out


def chunk_sweep(torch, pa, build, flush, default) -> None:
    """``paged_calls`` with the paged kernels built at every chunk length of
    ``CHUNKS`` (L2 flushed, median of CUDA events), one line per call; the
    wrappers are left on the default chunk length."""
    calls = paged_calls(torch, pa)
    times = {label: [] for label in calls}
    for chunk in CHUNKS:
        use_chunk(pa, build, chunk, default)
        for label, fn in calls.items():
            times[label].append(median_ms(torch, fn, flush))
    use_chunk(pa, build, default, default)
    print(f"paged kernels by chunk length (tokens a block covers; "
          f"{default} is the wrappers'), bf16, L2 flushed, median of CUDA "
          "events:")
    for label, ms in times.items():
        print(f"  {label}: " + ", ".join(
            f"C={c} {t:.4f} ms" for c, t in zip(CHUNKS, ms)))


def serve(torch, pa, fused=True, decode_steps=1, scheduler="gmg", spec=0,
          temperature=0.0, prompts=None, drafter=None, be=None):
    """Full-width tinyllama-1.1b through run(), on a backend of its own or,
    given ``be``, on that backend after ``reset_run_state`` with its
    attention mode, sampler and drafter set for this run; kernel launch
    counts are zeroed just before the run and read just after it.
    ``spec`` is the engine's draft-depth ceiling; temperature > 0 samples
    with top_k 50; ``prompts`` is ``ExperimentSpec.prompts``; ``drafter``
    replaces the n-gram drafter."""
    from repro_torch.examples.quickstart import _stream_digest
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving.backend import Sampler
    from repro_torch.serving.drafter import NgramDrafter
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.run import (BackendSpec, ExperimentSpec,
                                         TelemetrySpec, run)
    from repro_torch.serving.torch_backend import PagedTorchBackend
    from repro_torch.serving.workload import WorkloadSpec

    top_k = 50 if temperature > 0 else 0
    if be is None:
        be = PagedTorchBackend(**SERVE_KW, fused=fused,
                               temperature=temperature, top_k=top_k,
                               drafter=drafter)
        check(be.cfg.d_model == 2048 and be.cfg.num_layers == 22
              and be.cfg.dtype == "bfloat16", "full-width tinyllama config")
    else:
        be.reset_run_state()
        be.fused = fused
        be.sampler = Sampler(temperature=temperature, top_k=top_k,
                             seed=be._seed)
        be.drafter = drafter if drafter is not None else NgramDrafter()
    obs = MetricsRegistry()
    engine = EngineConfig(max_batch=8, prefill_budget=32,
                          decode_steps=decode_steps, spec_depth_max=spec,
                          tp=be.tp)
    zero_launches(pa, [be])
    t0 = time.perf_counter()
    summ = run(ExperimentSpec(
        scheduler=scheduler, workload=WorkloadSpec(**WORKLOAD),
        engine=engine, backend=BackendSpec(kind=be),
        telemetry=TelemetrySpec(obs=obs), prompts=prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = paged_launches(pa, [be])
    digest = _stream_digest(be)
    tokens = [t for toks in be.generated.values() for t in toks]
    how = ((" (motif prompts)" if prompts else "")
           + (f" ({type(drafter).__name__})" if drafter else ""))
    print(f"  {scheduler} fused={fused} decode_steps={decode_steps} "
          f"spec={spec} temperature={temperature}{how}"
          f"{f' tp={be.tp}' if be.tp > 1 else ''}: finished "
          f"{summ.n_finished}, goodput {summ.goodput_frac:.3f}, "
          f"{summ.throughput_tok_s:.1f} tok/s (engine clock), "
          f"{len(tokens)} tokens in {wall:.2f} s wall, launches {counts}, "
          f"decode forwards {be.n_decode_forwards}, verify forwards "
          f"{be.n_verify_forwards}, spec proposed {summ.spec_proposed} "
          f"accepted {summ.spec_accepted}, digest {digest}")
    print(f"    engine makespan {summ.makespan:.3f} s; backend dispatch "
          f"{obs.value_of('torch_dispatch_seconds_total'):.3f} s, host "
          f"{obs.value_of('torch_host_seconds_total'):.3f} s; "
          f"{be.n_decode_dispatches} decode calls, "
          f"{be.n_prefill_dispatches} prefill chunks")
    check(summ.n_finished > 0, "no request finished")
    check(summ.goodput_frac > 0, "zero goodput")
    check(all(0 <= t < be.cfg.vocab_size for t in tokens), "token range")
    return be, summ, counts, digest


def zero_launches(pa, backends) -> None:
    """Set the paged kernels' launch counts to 0 in this process and in
    every worker rank of ``backends``."""
    for k in pa.launches:
        pa.launches[k] = 0
    for be in backends:
        if be.tp > 1:
            be.rank_stats(reset=True)


def paged_launches(pa, backends) -> dict:
    """The paged kernels' launches since ``zero_launches``: this process's
    (every backend's rank 0) plus each worker rank's."""
    counts = dict(pa.launches)
    for be in backends:
        if be.tp > 1:
            for st in be.rank_stats()[1:]:
                for k in counts:
                    counts[k] += st["launches"][k]
    return counts


def fleet_run(torch, pa, cluster, tp=1):
    """Full-width tinyllama-1.1b on a fleet through ``run_cluster`` under
    gmg: each replica builds its own backend on the card (``SERVE_KW``;
    with ``tp`` > 1 its ranks share the card) and the replicas step in turn
    on the current stream.  Kernel launch counts are zeroed just before the
    run and read just after it (a replica's worker ranks start at 0).
    Prints one line for the fleet and one per replica.  Returns (fleet
    summary, the replicas' backends, merged digest, launches)."""
    from repro_torch.examples.quickstart import _stream_digest
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.run import (BackendSpec, ExperimentSpec,
                                         TelemetrySpec, run_cluster)
    from repro_torch.serving.workload import WorkloadSpec

    sink, obs = [], MetricsRegistry()
    zero_launches(pa, [])
    kwargs = dict(SERVE_KW)
    if tp > 1:
        kwargs.update(tp=tp, devices=["cuda:0"] * tp)
    t0 = time.perf_counter()
    fs = run_cluster(ExperimentSpec(
        scheduler="gmg", workload=WorkloadSpec(**WORKLOAD),
        engine=EngineConfig(max_batch=8, prefill_budget=32, tp=tp),
        backend=BackendSpec(kind="torch", kwargs=kwargs, sink=sink),
        cluster=cluster, telemetry=TelemetrySpec(obs=obs)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = paged_launches(pa, sink)
    digest = _stream_digest(sink)
    check(len(sink) == len(fs.per_replica) and all(
        be.device.type == "cuda" and be.cfg.d_model == 2048
        and be.cfg.num_layers == 22 and be.cfg.dtype == "bfloat16"
        for be in sink), "every replica is full-width tinyllama on the card")
    label = cluster.router + (f" {'+'.join(cluster.roles)}" if cluster.roles
                              else f" x{cluster.n_replicas}") \
        + (f" tp={tp}" if tp > 1 else "")
    print(f"  {label}: finished {fs.fleet.n_finished}, goodput "
          f"{fs.goodput_frac:.3f}, migrated {fs.fleet.migrated_in}, "
          f"{fs.fleet.throughput_tok_s:.1f} tok/s (engine clock), makespan "
          f"{fs.fleet.makespan:.3f} s, {wall:.2f} s wall (backends built "
          f"included), launches {counts}, digest {digest}")
    for rid, s in sorted(fs.per_replica.items()):
        role = cluster.roles[rid] if cluster.roles else "mixed"
        dispatch = obs.value_of("torch_dispatch_seconds_total", replica=rid)
        print(f"    replica {rid} ({role}): routed {fs.routed.get(rid, 0)}, "
              f"migrated in {s.migrated_in} out {s.migrated_out}, finished "
              f"{s.n_finished}, dispatch {dispatch:.3f} s, host "
              f"{obs.value_of('torch_host_seconds_total', replica=rid):.3f} s")
    check(fs.fleet.n_finished > 0 and fs.goodput_frac > 0,
          f"{label}: no goodput")
    check(counts["fused_decode_attention"] > 0,
          f"{label}: fused_decode_attention never launched")
    return fs, sink, digest, counts


def migration_round_trip(torch, a, b) -> None:
    """Prefill a request on backend ``a``, export its pages and import them
    into ``b`` at other page indices: bitwise equal, bf16 crossing the host
    as int16 patterns.  Then a swapped-out request (exported with an empty
    table, parked on ``b``, swapped in).  Prints the wall time of the
    export and the import beside the price ``migrate_time`` puts on the
    same tokens."""
    from repro_torch.models.convert import tree_leaves
    from repro_torch.serving.request import Request, SLOSpec

    def prefill(be, rid, table):
        r = Request(rid=rid, app="chatbot", arrival=0.0, prompt_len=40,
                    true_output_len=12, slo=SLOSpec("throughput", ttlt=60.0))
        be.begin_step()
        be.prefill_chunk(r, 0, r.prompt_len, table)
        be.step_time(r.prompt_len, [])
        return r

    def equal(ta, tb):
        return all(torch.equal(x[:, ta] if x.ndim == 5 else x[ta],
                               y[:, tb] if y.ndim == 5 else y[tb])
                   for x, y in zip(tree_leaves(a.pages), tree_leaves(b.pages)))

    for be in (a, b):
        be.reset_run_state()
    n = b.num_blocks
    ta, tb = [0, 1, 2], [n - 1, 7, n // 2]
    r = prefill(a, 10**6, ta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = a.kv_export_pages(r.rid, ta)
    t1 = time.perf_counter()
    b.kv_import_pages(r.rid, payload, tb)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    leaves = tree_leaves(payload["pages"])
    nbytes = sum(x.nbytes for x in leaves)
    priced = a.migrate_time(r.prompt_len * a.kv_bytes)
    check(all(x.dtype.name == "int16" for x in leaves),
          "bf16 pages cross the host as int16 patterns")
    check(equal(ta, tb), "migrated pages differ from the source's")
    check(b.prompt_ids(r).tolist() == payload["prompt"].tolist(),
          "the prompt did not travel with the pages")
    ts, tb2 = [3, 4, 5], [n - 2, 9, n // 4]
    r2 = prefill(a, 10**6 + 1, ts)
    a.kv_swap_out(r2.rid, ts, r2.prompt_len)
    b.kv_import_pages(r2.rid, a.kv_export_pages(r2.rid, []), None)
    b.kv_swap_in(r2.rid, tb2)
    check(equal(ts, tb2), "a swapped-out payload differs after kv_swap_in")
    print(f"  migration round trip (live and swapped): bitwise; "
          f"{r.prompt_len} tokens priced {priced * 1e3:.4f} ms "
          f"(migrate_time: {r.prompt_len} x {a.kv_bytes:.0f} B at "
          f"{a.interconnect_bw / 1e9:g} GB/s); measured export "
          f"{(t1 - t0) * 1e3:.3f} ms + import {(t2 - t1) * 1e3:.3f} ms wall "
          f"for {nbytes} B of pages ({len(ta)} pages x {len(leaves)} pools)")
    for be in (a, b):
        be.reset_run_state()


def fleet(torch, pa, colocated: str, card: str) -> None:
    """The multi-replica phase: a 1 prefill + 1 decode fleet under the
    disagg router (live KV migration) and 2 replicas under slo-margin, each
    with merged token streams equal to the colocated gmg run's
    (``colocated``), the migration round trip on two of the replicas'
    backends, and the paged kernels' ticket counters at zero afterwards."""
    from repro_torch.serving.run import ClusterSpec

    t0 = time.perf_counter()
    print("fleet: tinyllama-1.1b replicas (full width, bf16, random weights "
          "from seed 0), gmg:")
    di, sink, dig_d, _ = fleet_run(torch, pa, ClusterSpec(
        router="disagg", roles=["prefill", "decode"]))
    del sink
    torch.cuda.empty_cache()
    check(di.fleet.migrated_in > 0, "the disaggregated fleet migrated no "
          "request (the disagg router priced every migration out)")
    sm, sink, dig_s, _ = fleet_run(torch, pa, ClusterSpec(
        router="slo-margin", n_replicas=2))
    check(min(sm.routed.values()) > 0,
          f"slo-margin routed to one replica only: {sm.routed}")
    print(f"  digests: disagg {dig_d}, slo-margin {dig_s}, colocated "
          f"{colocated}")
    check(dig_d == colocated, "the disaggregated fleet changed the token "
          "streams")
    check(dig_s == colocated, "the routed fleet changed the token streams")
    migration_round_trip(torch, *sink)
    del sink
    torch.cuda.empty_cache()
    check(bool(pa._tickets) and pa.ticket_sum() == 0,
          "the paged kernels' ticket counters are not zero after the fleet")
    print(f"  ticket counters zero on {len(pa._tickets)} device(s); fleet "
          f"phase {time.perf_counter() - t0:.2f} s wall ({card})")


# ---------------------------------------------------------------------------
# tensor parallelism: the ranks of one backend share the card
# ---------------------------------------------------------------------------
def tp_kernels(torch, pa) -> dict:
    """The paged kernels at tinyllama's local heads under serving TP (H=16,
    KV=2 at tp=2; H=8, KV=1 at tp=4; D=64, bf16): the decode and attend
    kernels at the serving call's shape (8 live of 64 lanes) and the
    verify kernel at W=5, against their plain versions.  Returns each
    kernel's largest error."""
    errs = dict.fromkeys(pa.launches, 0.0)
    live = [1, 15, 16, 17, 32, 33, 48, 52]
    for tp, H, KV in ((2, 16, 2), (4, 8, 1)):
        label = f"H={H} KV={KV} D=64 (tinyllama's heads on a rank at tp={tp})"
        c = serving_case(torch, 64, live, seed=300 + tp, H=H, KV=KV, D=64)
        e = check_kernels(torch, pa, c, 2e-2, f"bf16 B=64 (8 live, ctx<=52)"
                          f" n_max=16 {label}", live=8)
        c = verify_case(torch, 8, 5, H, KV, 64, 16, live,
                        [5, 2, 5, 1, 4, 5, 3, 5], torch.bfloat16,
                        seed=310 + tp, lanes=64)
        e["fused_verify_attention"] = check_verify(
            torch, pa, c, 2e-2, f"bf16 64 lanes (8 live, ctx<=56) W=5 {label}")
        errs.update({k: max(errs[k], v) for k, v in e.items()})
    return errs


def tp_backend(torch, tp, **kw):
    """A full-width tinyllama-1.1b backend (``SERVE_KW``) of ``tp`` ranks
    sharing cuda:0 (tp=1: one rank)."""
    from repro_torch.serving.torch_backend import PagedTorchBackend

    if tp > 1:
        kw.update(tp=tp, devices=["cuda:0"] * tp)
    args = dict(SERVE_KW, **kw)
    if "config" in kw:
        args = {k: v for k, v in args.items() if k not in ("arch", "reduced")}
    return PagedTorchBackend(**args)


def rank_check(be, label) -> list:
    """The ranks' sampled-token hashes agree and every rank's ticket
    counters are zero; prints and returns each rank's stats."""
    be.check_ranks()
    stats = be.rank_stats()
    check(len({st["digest"] for st in stats}) == 1,
          f"{label}: the ranks' token hashes differ")
    check(all(st["tickets"] == 0 for st in stats),
          f"{label}: a rank's ticket counters are not zero")
    print(f"    {label}: ranks' token hashes agree "
          f"({stats[0]['digest']}), ticket counters zero on every rank, "
          f"data group {stats[0]['data']}")
    return stats


def tp_close(be, label) -> None:
    """Close ``be`` (its ranks' hashes checked again); every worker rank
    must have exited by itself with code 0."""
    be.close()
    if be.tp > 1:
        check(be.worker_exitcodes == [0] * (be.tp - 1),
              f"{label}: worker exit codes {be.worker_exitcodes}")
        print(f"    {label}: closed, worker exit codes "
              f"{be.worker_exitcodes}")


def serve_lanes(be, n_live, ctx):
    """Host inputs of a decode forward at ``ROWS`` lanes: ``n_live`` live
    lanes at position ``ctx - 1`` on tables of their own, the rest padding
    lanes on the all-scrap table."""
    import numpy as np
    from repro_torch.serving.torch_backend import ROWS

    per = -(-(ctx + 1) // be.page)
    tok = np.zeros((ROWS, 1), np.int32)
    pos = np.zeros(ROWS, np.int32)
    tabs = np.full((ROWS, be.n_max), be.scrap, np.int32)
    pos[:n_live] = ctx - 1
    tabs[:n_live, :per] = np.arange(n_live * per).reshape(n_live, per)
    return tok, pos, tabs


def tp_cost(torch, be, b1, card) -> None:
    """What sharing one card costs the ranks of a tp=2 decode forward (64
    lanes, 8 live at context 48): its wall time and rank 0's device-busy
    time beside tp=1's, the collectives it makes on each rank (2 per layer
    + 1 gather), and each rank's host time inside them over ``reps`` more
    forwards (its device synchronised, the wait for the other rank and the
    sum included).  Ranks sharing one card: not a measure of TP speed."""
    reps, warmup = 10, 3
    inputs = serve_lanes(be, 8, 48)
    w1, busy1, _, _ = profiled(torch, lambda: b1.decode_logits(*inputs),
                               reps=reps, warmup=warmup)
    wall, busy, n, top = profiled(torch, lambda: be.decode_logits(*inputs),
                                  reps=reps, warmup=warmup)
    be.rank_stats(reset=True)
    for _ in range(reps):
        be.decode_logits(*inputs)
    torch.cuda.synchronize()
    stats = be.rank_stats(reset=True)
    calls = [st["collectives"] / reps for st in stats]
    want = 2 * be.cfg.num_layers + 1
    check(calls == [want] * be.tp, f"tp=2 decode forward: {calls} "
          f"collectives per rank, want {want}")
    print(f"  cost of ranks sharing one card (tp=2 decode forward, 64 lanes, "
          f"8 live at ctx 48; {card}): wall {wall:.3f} ms (tp=1 {w1:.3f} ms),"
          f" rank 0's device busy {busy:.3f} ms (tp=1 {busy1:.3f} ms), idle "
          f"share {1 - busy / wall:.3f} of rank 0's wall; {want} "
          f"collectives per forward on each rank, host ms inside them per "
          f"forward: " + ", ".join(
              f"rank {st['rank']} {st['collective_s'] / reps * 1e3:.3f}"
              for st in stats)
          + " (ranks sharing one card: not a TP speed)")
    for ms, count, key in top[:6]:
        print(f"    {ms:.4f} ms x{count} {key[:90]}")


def tp_logits(torch, b1, b2) -> None:
    """Full-depth bf16, tp=2 against tp=1 on identical pools: 8 prompts
    prefilled at tp=1, their pages imported into the tp=2 pool (each rank
    its heads), one decode forward on each; prints the largest logit
    difference on the live lanes."""
    import numpy as np
    from repro_torch.serving.request import Request, SLOSpec

    tok, pos, tabs = serve_lanes(b1, 8, 40)
    for be in (b1, b2):
        be.reset_run_state()
    for i in range(8):
        r = Request(rid=10**6 + i, app="chatbot", arrival=0.0, prompt_len=40,
                    true_output_len=12, slo=SLOSpec("throughput", ttlt=60.0))
        table = [int(t) for t in tabs[i, :3]]
        b1.begin_step()
        b1.prefill_chunk(r, 0, r.prompt_len, table)
        b1.step_time(r.prompt_len, [])
        tok[i, 0] = b1.prompt_ids(r)[-1]
        b2.kv_import_pages(r.rid, b1.kv_export_pages(r.rid, table), table)
    l1 = b1.decode_logits(tok, pos, tabs)[:8]
    l2 = b2.decode_logits(tok, pos, tabs)[:8]
    d = (l1 - l2).abs()
    same = int((l1.argmax(-1) == l2.argmax(-1)).sum())
    print(f"  bf16 full depth, tp=2 vs tp=1, one decode forward on identical "
          f"pools (8 lanes at ctx 40): max|dlogit| {d.max().item():.4e}, "
          f"mean {d.mean().item():.4e}, largest |logit| "
          f"{l1.abs().max().item():.3f}; argmax equal on {same} of 8 lanes")
    for be in (b1, b2):
        be.reset_run_state()
    check(bool(np.isfinite(d.cpu().numpy()).all()), "tp=2 logits finite")


def tp_first_differences(torch, b1, streams1, streams2, label) -> None:
    """For each stream of the workload that ``streams2`` (a tp > 1 run)
    emits differently from ``streams1`` (the tp=1 run): the first token
    that differs and tp=1's top-2 logit gap at that step.  The gap comes
    from a replay at tp=1: the single request's prompt prefilled, then its
    tp=1 tokens decoded one step at a time, which batch invariance makes
    bitwise the run's steps (checked: the replay's argmax is tp=1's
    token).  DAG stages' prompts are made by the engine: only their
    first difference is printed."""
    import numpy as np
    from repro_torch.serving.workload import WorkloadGen, WorkloadSpec

    singles = {r.rid: r for r in WorkloadGen(WorkloadSpec(**WORKLOAD))
               .generate()[0]}
    differ = sorted(rid for rid in streams1
                    if streams1[rid] != streams2.get(rid))
    print(f"  {label}: {len(differ)} of {len(streams1)} streams differ from "
          f"tp=1's")
    b1.reset_run_state()
    for rid in differ:
        s1, s2 = streams1[rid], streams2.get(rid, [])
        i = next(j for j in range(len(s1)) if j >= len(s2) or s1[j] != s2[j])
        r = singles.get(rid)
        if r is None:
            print(f"    r{rid} (a DAG stage): first difference at token {i}")
            continue
        L = r.prompt_len
        table = list(range(-(-(L + i + 1) // b1.page)))
        b1.begin_step()
        b1.prefill_chunk(r, 0, L, table)
        b1.step_time(L, [])
        prompt = b1.prompt_ids(r)
        for j in range(i + 1):
            tok, pos, tabs = serve_lanes(b1, 1, L + j)
            tok[0, 0] = prompt[-1] if j == 0 else s1[j - 1]
            tabs[0, :len(table)] = table
            logits = b1.decode_logits(tok, pos, tabs)[0]
        top2 = logits.topk(2)
        v, ix = top2.values.tolist(), top2.indices.tolist()
        print(f"    r{rid}: first difference at token {i} of {len(s1)}: tp=1 "
              f"{s1[i]}, tp>1 {s2[i] if i < len(s2) else None}; tp=1's "
              f"top-2 gap there {v[0] - v[1]:.4e} ({ix[0]} over {ix[1]})")
        check(ix[0] == s1[i], f"r{rid}: the tp=1 replay's argmax {ix[0]} is "
              f"not the run's token {s1[i]}")
        b1.kv_release(r.rid)
    b1.reset_run_state()


def tp_phase(torch, pa, card, streams1) -> tuple:
    """Serving tensor parallelism, its ranks sharing cuda:0 (the data group
    over shared device buffers): the paged kernels at the ranks' local
    heads; full-width tinyllama-1.1b in bf16 at tp=2 and tp=4 (gmg fused
    n=1, fused n=4, unfused; vllm with motif prompts at spec 0 and spec 4:
    equal digests within each scheduler and degree), the tp=2 streams'
    first differences from tp=1's (``streams1``) with tp=1's top-2 gaps,
    the logits on identical pools, the cost of sharing the card; a 1
    prefill + 1 decode fleet at tp=2 (merged digest equal to the tp=2
    colocated run's); full width cut to 2 layers in f32 at tp=1, 2 and 4
    (equal digests).  Every run checks the ranks' hashes and ticket
    counters.  Returns (each kernel's largest error at the local heads, the
    paged kernels' launches summed over the phase's runs and ranks)."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.run import ClusterSpec
    from repro_torch.serving.torch_backend import ROWS

    t0 = time.perf_counter()
    print("tensor parallelism, the ranks sharing one card (cuda:0):")
    errs = tp_kernels(torch, pa)
    total = dict.fromkeys(pa.launches, 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    b1 = tp_backend(torch, 1)
    gmg = {}
    for tp in (2, 4):
        t1 = time.perf_counter()
        be = tp_backend(torch, tp)
        print(f"  tp={tp}: plan {be.plan}, {be.num_blocks} pages in the "
              f"engine's pool, data group {be.data.kind}; built in "
              f"{time.perf_counter() - t1:.1f} s")
        digs = {}
        for name, kw in (("gmg fused n=1", dict()),
                         ("gmg fused n=4", dict(decode_steps=4)),
                         ("gmg unfused n=1", dict(fused=False)),
                         ("vllm spec 0", dict(scheduler="vllm",
                                              prompts=motif_prompts)),
                         ("vllm spec 4", dict(scheduler="vllm", spec=4,
                                              prompts=motif_prompts))):
            _, summ, counts, digs[name] = serve(torch, pa, be=be, **kw)
            add(counts)
            kernel = ("paged_attention" if name.startswith("gmg unfused")
                      else "fused_decode_attention")
            check(counts[kernel] > 0, f"tp={tp} {name}: {kernel} never "
                  "launched")
            if "spec 4" in name:
                check(summ.spec_proposed > 0 and
                      counts["fused_verify_attention"] > 0,
                      f"tp={tp} {name}: no verify forward")
            if name == "gmg fused n=1":
                gmg[tp] = {r: list(t) for r, t in be.generated.items()}
            stats = rank_check(be, f"tp={tp} {name}")
            print(f"    launches per rank: " + ", ".join(
                f"rank {st['rank']} {st['launches']['fused_decode_attention']}"
                f" decode / {st['launches']['paged_attention']} attend / "
                f"{st['launches']['fused_verify_attention']} verify"
                for st in stats))
        print(f"  tp={tp} digests: " + ", ".join(f"{k} {v}"
                                                 for k, v in digs.items()))
        check(digs["gmg fused n=4"] == digs["gmg fused n=1"]
              == digs["gmg unfused n=1"], f"tp={tp}: gmg digests differ")
        check(digs["vllm spec 4"] == digs["vllm spec 0"],
              f"tp={tp}: spec 4 changed the vllm streams")
        tp_first_differences(torch, b1, streams1, gmg[tp],
                             f"tp={tp} gmg fused n=1 vs tp=1")
        if tp == 2:
            check(batch_invariance(torch, be, ROWS, ("fixed",))["fixed"],
                  "tp=2: results depend on the batch grouping or the "
                  "prefill chunking")
            tp_logits(torch, b1, be)
            tp_cost(torch, be, b1, card)
            gmg_digest = digs["gmg fused n=1"]
        tp_close(be, f"tp={tp}")
        del be
        torch.cuda.empty_cache()
    b1.close()
    del b1
    torch.cuda.empty_cache()

    fs, sink, dig, counts = fleet_run(torch, pa, ClusterSpec(
        router="disagg", roles=["prefill", "decode"]), tp=2)
    add(counts)
    check(fs.fleet.migrated_in > 0, "the tp=2 fleet migrated no request")
    for i, be in enumerate(sink):
        rank_check(be, f"tp=2 fleet replica {i}")
        tp_close(be, f"tp=2 fleet replica {i}")
    del sink
    torch.cuda.empty_cache()
    print(f"  tp=2 digests: disagg fleet {dig}, colocated gmg {gmg_digest}")
    check(dig == gmg_digest, "the tp=2 disaggregated fleet changed the "
          "token streams")

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32",
                              num_layers=TP_F32_LAYERS)
    f32 = {}
    for tp in (1, 2, 4):
        be = tp_backend(torch, tp, config=cfg)
        _, _, counts, f32[tp] = serve(torch, pa, be=be, decode_steps=4)
        add(counts)
        if tp > 1:
            rank_check(be, f"f32 tp={tp}")
        tp_close(be, f"f32 tp={tp}")
        del be
        torch.cuda.empty_cache()
    print(f"  f32, full width cut to {TP_F32_LAYERS} layers, gmg fused n=4: "
          f"digests tp=1 {f32[1]}, tp=2 {f32[2]}, tp=4 {f32[4]}")
    check(f32[2] == f32[1] and f32[4] == f32[1],
          "f32 tp=2 / tp=4 streams differ from tp=1's")
    print(f"  tensor-parallel phase: {time.perf_counter() - t0:.1f} s wall, "
          f"paged launches over its runs and ranks {total} ({card})")
    return errs, total


# ---------------------------------------------------------------------------
# the roofline of a decode dispatch, and expert parallelism over ranks
# ---------------------------------------------------------------------------
# live lanes of the decode dispatches profiled (the call computes ROWS)
ROOFLINE_LIVE = (1, 8, 64)
ROOFLINE_STEPS = 4
# the MoE layer of the EP phase: deepseek-v2-lite-16b at full width (d 2048,
# 64 experts top-6, expert d_ff 1408, 2 shared), x (2, 1024, 2048) in
# prefill ('weights' mode) and 64 decode lanes (64, 1, 2048) under decode
# TP ('tokens' mode); grids (data, model) of ranks sharing cuda:0
EP_ARCH = "deepseek-v2-lite-16b"
EP_GRIDS = {(1, 2): ("weights",), (1, 4): ("weights",),
            (2, 2): ("weights", "tokens")}
EP_X = {"weights": (2, 1024, 2048), "tokens": (64, 1, 2048)}
# ranks against moe_ep_ref on the card: f32 within 1e-5; bf16 within 2^-6
# of the largest |value| of the plain version's output (its GEMMs, gathers
# and sums are the ranks' at the ranks' shapes, so a few bf16 ulps of the
# output at most)
EP_F32_ATOL = 1e-5
EP_BF16_REL = 2.0 ** -6
EP_SLOT_BYTES = 64 << 20
EP_REPS = 3


def roofline_phase(torch, pa, card) -> int:
    """``roofline_decode_step`` at full-width tinyllama-1.1b on the card,
    fused decode, at 1, 8 and 64 live lanes, one dispatch and the window
    of 4 tokens: one line per record.  The fused decode kernel must report
    its cost (``hlo_opaque`` false).  Returns the kernel's launches in the
    phase (counted from 0)."""
    from repro_torch.launch.roofline import roofline_decode_step
    from repro_torch.obs import MetricsRegistry

    t0 = time.perf_counter()
    print(f"roofline of one decode dispatch, tinyllama-1.1b full width, "
          f"fused, bf16 ({card}; H100 SXM spec peaks: 989 TFLOP/s bf16, "
          f"3.35 TB/s):")
    reg = MetricsRegistry()
    for k in pa.launches:
        pa.launches[k] = 0
    for live in ROOFLINE_LIVE:
        rec = roofline_decode_step(
            arch="tinyllama-1.1b", batch=live, num_blocks=64, page=16,
            max_len=256, repeats=10, registry=reg, steps=ROOFLINE_STEPS,
            device="cuda", reduced=False)
        check(not rec["hlo_opaque"], f"live {live}: a kernel launched "
              "without reporting its cost")
        check(rec["kernel_reports"].get("fused_decode_attention") == 22,
              f"live {live}: {rec['kernel_reports']} kernel reports, not "
              "22 fused decode launches")
        check(rec["measured_s"] > 0 and rec["multi_measured_s"] > 0,
              f"live {live}: no time measured")
        print(f"  live {live}, {rec['batch']} lanes computed, steps 1: "
              f"measured {rec['measured_s'] * 1e3:.4f} ms, roofline "
              f"{rec['roofline_s'] * 1e3:.5f} ms ({rec['dominant']}: compute "
              f"{rec['t_compute_s'] * 1e3:.5f}, memory opt "
              f"{rec['t_memory_opt_s'] * 1e3:.5f} / pess "
              f"{rec['t_memory_s'] * 1e3:.5f} ms), counted "
              f"{rec['hlo_flops_per_chip']:.6g} FLOP, "
              f"{rec['hlo_bytes_opt_per_chip']:.6g} B opt, "
              f"{rec['hlo_bytes_per_chip']:.6g} B pess, model "
              f"{rec['model_flops']:.6g} FLOP, mfu measured "
              f"{rec['mfu_measured']:.6f}, bound {rec['mfu_bound']:.4f}, "
              f"opaque {rec['hlo_opaque']}")
        print(f"  live {live}, {rec['batch']} lanes computed, steps "
              f"{rec['multi_steps']}: window {rec['multi_measured_s'] * 1e3:.4f}"
              f" ms, {rec['multi_measured_s_per_token'] * 1e3:.4f} ms a "
              f"token, speedup per token {rec['multi_speedup_per_token']:.4f}"
              f", counted {rec['multi_hlo_flops_per_chip']:.6g} FLOP, "
              f"{rec['multi_hlo_bytes_per_chip']:.6g} B")
        torch.cuda.empty_cache()
    launches = pa.launches["fused_decode_attention"]
    check(launches > 0, "fused_decode_attention never launched in the "
          "roofline phase")
    print(f"  roofline phase: {time.perf_counter() - t0:.1f} s, "
          f"fused_decode_attention launches {launches}")
    return launches


def _ep_inputs(torch, cfg, mode, dtype, device):
    """The EP phase's weights and input, drawn from seed 5 on ``device``
    (every rank draws the same)."""
    g = torch.Generator(device=device).manual_seed(5)
    E, d, F = cfg.num_experts, cfg.d_model, cfg.d_ff_expert

    def rnd(*shape, scale=0.02):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    p = {"router": rnd(d, E), "w_gate": rnd(E, d, F), "w_up": rnd(E, d, F),
         "w_down": rnd(E, F, d)}
    return rnd(*EP_X[mode], scale=1.0), p


def _ep_case_ctx(cfg, mesh, mode, groups=None):
    from repro_torch.launch.sharding import make_ctx

    phase = "decode" if mode == "tokens" else "prefill"
    kw = {} if groups is None else dict(ep_group=groups["model"],
                                        fsdp_group=groups["data"])
    return make_ctx(cfg, mesh, phase, decode_tp=mode == "tokens", **kw)


def _ep_rank(groups, rank, mesh, modes):
    """One rank of an EP grid: for each mode and dtype, its shards, one
    warm-up, then ``EP_REPS`` timed ``moe_ep`` calls (CUDA events; the
    ranks time-share the card and wait for each other in the
    collectives).  Returns [(mode, dtype, output block on the host, kept
    choices, median ms)]."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import ep_shards, moe_ep

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(EP_ARCH)
    dev = mesh.devices[rank]
    out = []
    for mode in modes:
        for dtype in (torch.float32, torch.bfloat16):
            ctx = _ep_case_ctx(cfg, mesh, mode, groups)
            x, p = _ep_inputs(torch, cfg, mode, dtype, dev)
            xs, ps = ep_shards(x, p, cfg, ctx, rank)
            del x, p
            st = {}
            y = moe_ep(xs, ps, cfg, ctx, stats=st)
            times = []
            for _ in range(EP_REPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                moe_ep(xs, ps, cfg, ctx)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            out.append((mode, str(dtype), y.cpu(), int(st["kept"]),
                        sorted(times)[len(times) // 2]))
            del xs, ps, y
            torch.cuda.empty_cache()
    return out


def ep_phase(torch, card) -> None:
    """Expert-parallel MoE at deepseek-v2-lite-16b's full width on ranks
    sharing cuda:0 (``serving.tp.run_grid``; their collectives through
    shared device buffers): grids (1, 2) and (1, 4) in 'weights' mode and
    (2, 2) in 'weights' and decode 'tokens' mode, each in f32 and bf16, one
    rank group per grid.  Each rank's output block is held against
    ``moe_ep_ref`` on the card (f32 within ``EP_F32_ATOL``, bf16 within
    ``EP_BF16_REL`` of the largest value), the kept expert choices equal in
    number; every rank's exit code 0.  The ranks' device ms are printed
    beside the dense ``moe_dense`` on the same input: a finding, not a
    claim (the ranks time-share one card)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import ep_shards, moe_dense, moe_ep_ref
    from repro_torch.serving.tp import run_grid

    t0 = time.perf_counter()
    cfg = get_config(EP_ARCH)
    dev = torch.device("cuda", 0)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    print(f"expert parallelism, {EP_ARCH} MoE layer at full width (d "
          f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k}, expert "
          f"d_ff {cfg.d_ff_expert}, capacity factor {cfg.capacity_factor}), "
          f"ranks sharing cuda:0 ({card}):")
    dense_ms = {}
    for grid, modes in EP_GRIDS.items():
        t1 = time.perf_counter()
        mesh = make_local_mesh(model=grid[1], data=grid[0], device=dev)
        results, codes = run_grid(_ep_rank, mesh, (mesh, modes),
                                  slot_bytes=EP_SLOT_BYTES)
        check(all(c == 0 for c in codes), f"EP grid {grid}: worker exit "
              f"codes {codes}")
        spawn_s = time.perf_counter() - t1
        for i, (mode, dtype_name, _, _, _) in enumerate(results[0]):
            dtype = getattr(torch, dtype_name.split(".")[-1])
            ctx = _ep_case_ctx(cfg, mesh, mode)
            x, p = _ep_inputs(torch, cfg, mode, dtype, dev)
            st = {}
            y_ref = moe_ep_ref(x, p, cfg, ctx, stats=st)
            kept = sum(r[i][3] for r in results)
            check(kept == int(st["kept"]), f"EP grid {grid} {mode} "
                  f"{dtype_name}: kept {kept} != the plain version's "
                  f"{int(st['kept'])}")
            scale = float(y_ref.float().abs().max())
            tol = EP_F32_ATOL if dtype == torch.float32                 else EP_BF16_REL * scale
            err = 0.0
            for r in range(mesh.size):
                want = ep_shards(y_ref, p, cfg, ctx, r)[0].float().cpu()
                got = results[r][i][2].float()
                check(got.shape == want.shape and bool(torch.isfinite(
                    got).all()), f"EP grid {grid} rank {r}: bad output")
                err = max(err, float((got - want).abs().max()))
            check(err <= tol, f"EP grid {grid} {mode} {dtype_name}: max "
                  f"|rank - plain| {err:.3g} > {tol:.3g}")
            key = (mode, dtype_name)
            if key not in dense_ms:
                dense_ms[key] = median_ms(torch, lambda: moe_dense(x, p, cfg),
                                          flush, reps=EP_REPS)
            rank_ms = [r[i][4] for r in results]
            print(f"  grid {grid} {mode} {dtype_name} x {tuple(x.shape)}: "
                  f"max |rank - moe_ep_ref| {err:.3g} (tolerance {tol:.3g}), "
                  f"kept {kept} expert choices (= plain), ranks' moe_ep ms "
                  f"{', '.join(f'{t:.3f}' for t in rank_ms)} vs dense "
                  f"moe_dense {dense_ms[key]:.3f} ms on one process")
            del x, p, y_ref
            torch.cuda.empty_cache()
        print(f"  grid {grid}: {mesh.size} ranks, exit codes {codes}, "
              f"{time.perf_counter() - t1:.1f} s ({spawn_s:.1f} s in the "
              f"ranks)")
    print(f"  EP phase: {time.perf_counter() - t0:.1f} s")


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def batch_invariance(torch, be, rows,
                     names=("fixed", "power-of-two")) -> dict:
    """Whether full-width results are bitwise independent of how the
    engine groups and chunks work, under two padding policies: the
    backend's (``rows`` lanes per decode call, ``rows``-token prefill
    calls) and the reference's power-of-two widths (``names`` picks
    them).  Eight lanes at contexts 5-52 are decoded in groups of 1, 2, 4
    and 8 lanes per call, each group padded to the policy's width, and each
    lane's logits held against the groups-of-8 run; one 52-token prompt is
    prefilled in three chunkings and its KV compared.  The calls go
    through the backend (``on_ranks``, ``decode_logits``,
    ``kv_export_pages``), so they run on every rank under tensor
    parallelism.  Prints each policy; returns {policy: all bitwise
    equal}."""
    import numpy as np
    from repro_torch.models.convert import tree_leaves

    g = torch.Generator(device="cuda").manual_seed(3)
    ctxs = [5, 16, 17, 33, 40, 48, 49, 52]
    per = -(-max(ctxs) // be.page)            # pages per lane
    policies = {"fixed": (lambda n: rows, lambda n: rows),
                "power-of-two": (lambda n: _pow2(n, 1),
                                 lambda n: _pow2(n, 8))}

    def ints(*shape):
        return torch.randint(0, be.cfg.vocab_size, shape, generator=g,
                             device="cuda", dtype=torch.int32).cpu().numpy()

    def table(first):
        t = np.full(be.n_max, be.scrap, np.int32)
        t[:per] = np.arange(first, first + per)
        return t

    def prefill(tab, prompt, chunks, width):
        calls, start = [], 0
        for n in chunks:
            toks = np.zeros(width(n), np.int32)
            toks[:n] = prompt[start:start + n]
            calls.append((width(n), toks, start, tab, n))
            start += n
        be.on_ranks("_prefill_dev", calls)

    def kv_of(tab, n):
        pages = be.kv_export_pages(-1, [int(t) for t in tab[:per]])["pages"]
        out = []
        for a in tree_leaves(pages):
            t = torch.from_numpy(a)
            if t.dtype == torch.int16:               # bf16 bit patterns
                t = t.view(torch.bfloat16)
            t = t.flatten(1, 2)[:, :n] if t.dim() == 5 else \
                t.flatten(0, 1)[:n]
            out.append(t.float().reshape(-1))
        return torch.cat(out)

    # the decode lanes: each prefilled to ctx-1 tokens on its own pages
    tabs = np.stack([table(i * per) for i in range(8)])
    for i, c in enumerate(ctxs):
        prefill(tabs[i], ints(c - 1), [c - 1], policies["fixed"][1])
    tok = ints(8, 1)
    pos = np.asarray(ctxs, np.int32) - 1
    prompt = ints(52)

    def decode(group, width):
        """The 8 lanes' logits from calls of ``group`` live lanes each,
        padded to ``width(group)`` lanes on the all-scrap table."""
        outs = []
        W = width(group)
        for lo in range(0, 8, group):
            t = np.zeros((W, 1), np.int32)
            p = np.zeros(W, np.int32)
            tb = np.full((W, be.n_max), be.scrap, np.int32)
            t[:group], p[:group] = tok[lo:lo + group], pos[lo:lo + group]
            tb[:group] = tabs[lo:lo + group]
            outs.append(be.decode_logits(t, p, tb)[:group])
        return torch.cat(outs)

    result = {}
    for k, name in enumerate(names):
        dec_w, pf_w = policies[name]
        kvs = []
        for i, chunks in enumerate(([52], [32, 20], [16, 16, 16, 4])):
            tab = table((8 + 3 * k + i) * per)
            prefill(tab, prompt, chunks, pf_w)
            kvs.append(kv_of(tab, 52))
        pf_diff = max((kv - kvs[0]).abs().max().item() for kv in kvs[1:])
        base = decode(8, dec_w)
        parts, equal = [], pf_diff == 0
        for group in (1, 2, 4):
            lg = decode(group, dec_w)
            same = sum(bool(torch.equal(lg[i], base[i])) for i in range(8))
            top = int((lg.argmax(-1) == base.argmax(-1)).sum())
            parts.append(f"{group}: {same}/8 bitwise, argmax {top}/8, "
                         f"max|diff| {(lg - base).abs().max().item():.3e}")
            equal = equal and same == 8
        label = f" (tp={be.tp})" if be.tp > 1 else ""
        print(f"  batch invariance{label}, {name} padding: decode in groups "
              f"of [{'; '.join(parts)}] vs groups of 8; prefill KV of 52 "
              f"tokens in chunks 32+20 and 16x3+4 vs 52: max|diff| "
              f"{pf_diff:.3e}; {'all equal' if equal else 'NOT all equal'}")
        result[name] = equal
    return result


def verify_vs_decode(torch, be, rows) -> None:
    """Full-width ``verify_paged`` logits bitwise equal to ``decode_paged``
    logits at the same positions: ``rows`` lanes, 8 live at contexts 5-52
    with window widths 1-5, the rest padding at width 0.  Each live lane's
    prompt is prefilled twice, on two sets of pages; one copy is verified
    in one forward, the other decoded row by row (rows past a lane's width
    on the all-scrap table, as the plain verify version does).  Both row
    layouts: the live rows packed into ``rows``-row slabs (the backend's)
    and W slabs of every lane's row s."""
    from repro_torch.models.model import verify_slabs

    g = torch.Generator(device="cuda").manual_seed(4)
    ctxs = [5, 16, 17, 33, 40, 48, 49, 52]
    widths = [5, 1, 4, 5, 2, 5, 3, 5]
    W, dev = max(widths), "cuda"
    per = -(-(max(ctxs) + W) // be.page)

    def ints(*shape):
        return torch.randint(0, be.cfg.vocab_size, shape, generator=g,
                             device=dev, dtype=torch.int32)

    scrap = torch.full((rows, be.n_max), be.scrap, dtype=torch.int32,
                       device=dev)
    tabs = {k: scrap.clone() for k in ("packed", "per-row", "decode")}
    for i, c in enumerate(ctxs):
        prompt = torch.zeros((1, rows), dtype=torch.int32, device=dev)
        prompt[0, :c - 1] = ints(c - 1)
        for k, tab in enumerate(tabs.values()):
            first = (200 + (3 * i + k) * per)
            tab[i, :per] = torch.arange(first, first + per,
                                        dtype=torch.int32, device=dev)
            be.pages = be.model.prefill_paged(be.params, be.pages, prompt, 0,
                                              tab[i], c - 1)
    toks = torch.zeros((rows, W), dtype=torch.int32, device=dev)
    toks[:len(ctxs)] = ints(len(ctxs), W)
    pos0 = torch.zeros(rows, dtype=torch.int32, device=dev)
    pos0[:len(ctxs)] = torch.tensor(ctxs, dtype=torch.int32, device=dev) - 1
    wid = torch.zeros(rows, dtype=torch.int32, device=dev)
    wid[:len(ctxs)] = torch.tensor(widths, dtype=torch.int32, device=dev)
    slabs = torch.from_numpy(verify_slabs(wid.cpu().numpy(), W, rows)).to(dev)
    lv = {}
    for name, layout in (("packed", slabs), ("per-row", None)):
        lv[name], be.pages = be.model.verify_paged(
            be.params, be.pages, toks, pos0, wid, tabs[name], layout)
        check(tuple(lv[name].shape) == (rows, W, be.cfg.vocab_size)
              and bool(torch.isfinite(lv[name]).all()), "verify logits")
    same = dict.fromkeys(lv, 0)
    total, worst = 0, 0.0
    for s in range(W):
        tab_s = torch.where(wid[:, None] > s, tabs["decode"], scrap)
        ld, be.pages = be.model.decode_paged(
            be.params, be.pages, toks[:, s:s + 1].contiguous(), pos0 + s,
            tab_s, fused=True)
        for b in range(len(ctxs)):
            if s < widths[b]:
                total += 1
                for name, lg in lv.items():
                    same[name] += bool(torch.equal(lg[b, s], ld[b]))
                    worst = max(worst, (lg[b, s] - ld[b]).abs().max().item())
    print(f"  verify vs decode logits at full width, {rows} lanes (8 live, "
          f"W={W}): live rows bitwise equal {same['packed']}/{total} "
          f"packed into {slabs.shape[0]} slab(s), {same['per-row']}/{total} "
          f"in {W} per-row slabs; max|diff| {worst:.3e}")
    check(all(n == total for n in same.values()),
          "verify logits differ from decode logits")


def profiled(torch, fn, reps=10, warmup=3, cpu=True):
    """One call's time: the host clock over ``reps`` calls ending in a
    synchronise (after ``warmup`` warm-up calls), and the profiler's device
    time by kernel over ``reps`` more (``cpu=False``: the device's
    activity alone, for calls of hundreds of thousands of kernels, whose
    host-side events take the profiler minutes to sort).  Returns (wall
    ms, device-busy ms, kernels, [(ms, launches, name)] largest first),
    all per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0.0)

    # device kernels only: not the runtime's calls, copies, fills, or the
    # launch queue's stalls ("Command Buffer Full") the profiler also lists
    # with device time
    kernels = [e for e in prof.key_averages() if dev_us(e) > 0
               and not e.key.startswith(("aten::", "cuda", "cuLaunch",
                                         "Command Buffer", "Memcpy",
                                         "Memset"))]
    busy_ms = sum(dev_us(e) for e in kernels) / reps / 1e3
    top = [(dev_us(e) / reps / 1e3, e.count // reps, e.key)
           for e in sorted(kernels, key=dev_us, reverse=True)]
    return wall_ms, busy_ms, sum(e.count for e in kernels) / reps, top


def sampler_breakdown(torch) -> None:
    """What seeded sampling at temperature > 0 adds to a decode step: one
    ``sample_device`` call on the decode call's 64 rows of 32000 f32
    logits at temperature 0.8, top_k 50 (the threefry key chain, the
    Gumbel draw, top-k and argmax in plain torch ops)."""
    from repro_torch.serving.backend import Sampler

    g = torch.Generator(device="cuda").manual_seed(5)
    logits = torch.randn((64, 32000), generator=g, device="cuda")
    rids = torch.arange(64, dtype=torch.int32, device="cuda")
    pos = torch.full((64,), 47, dtype=torch.int32, device="cuda")
    sampler = Sampler(temperature=0.8, top_k=50, seed=0)
    wall_ms, busy_ms, n, _ = profiled(
        torch, lambda: sampler.sample_device(logits, rids, pos))
    print(f"  sampler at temperature 0.8, top_k 50, 64 rows x 32000: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, {n:.0f} kernels "
          f"per call (greedy: 1 argmax)")


def decode_breakdown(torch, be) -> None:
    """Where one full-width forward's time goes at the serving path's call
    shape, 64 lanes with 8 live at context 48: a decode forward, and a
    verify forward with a window of 5 rows on each live lane, its 40 live
    rows packed into one 64-row slab (the backend's layout) and, for
    comparison, as 5 slabs of every lane's row s.  Then a decode forward
    and a packed verify forward at context 240 (the window's last row at
    244, under the backend's ``max_len`` 256), where the verify kernel's
    share of a verify forward is largest.  For a model with MoE layers,
    ``moe_decode`` on the decode forward at context 48."""
    from repro_torch.models.model import verify_slabs

    B, live, W = 64, 8, 5
    tok = torch.zeros((B, W), dtype=torch.int32, device="cuda")
    wid = torch.zeros(B, dtype=torch.int32, device="cuda")
    wid[:live] = W
    tok1 = tok[:, :1].contiguous()
    slabs = torch.from_numpy(verify_slabs(wid.cpu().numpy(), W, B)).cuda()
    for ctx in (48, 240):
        pos = torch.zeros(B, dtype=torch.int32, device="cuda")
        pos[:live] = ctx - 1
        tabs = torch.full((B, be.n_max), be.scrap, dtype=torch.int32,
                          device="cuda")
        per = -(-(ctx + W) // be.page)
        tabs[:live, :per] = torch.arange(live * per, dtype=torch.int32,
                                         device="cuda").reshape(live, -1)
        calls = {
            "decode forward": lambda: be.model.decode_paged(
                be.params, be.pages, tok1, pos, tabs, fused=True),
            f"verify forward (W={W}, packed)": lambda: be.model.verify_paged(
                be.params, be.pages, tok, pos, wid, tabs, slabs)}
        if ctx == 48:
            calls[f"verify forward (W={W}, per-row slabs)"] = (
                lambda: be.model.verify_paged(be.params, be.pages, tok, pos,
                                              wid, tabs))
        for name, fn in calls.items():
            wall_ms, busy_ms, n, top = profiled(torch, fn)
            attn = sum(ms for ms, _, key in top if "paged_kernel" in key)
            print(f"  {name}, {B} lanes ({live} live at ctx {ctx}): wall "
                  f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle "
                  f"share {1 - busy_ms / wall_ms:.3f}), {n:.0f} kernels, "
                  f"attention kernel {attn:.4f} ms ({attn / busy_ms:.3f} of "
                  "busy)")
            for ms, count, key in top[:8]:
                print(f"    {ms:.4f} ms x{count} {key[:90]}")
            if name == "decode forward" and ctx == 48 and moe_layers(be.cfg):
                moe_decode(torch, be, fn, busy_ms, top)


def moe_layers(cfg) -> int:
    """Number of layers of ``cfg`` whose FFN is "moe"."""
    return (sum(f == "moe" for _, f in cfg.prefix_pattern)
            + cfg.num_units * sum(f == "moe" for _, f in cfg.unit_pattern))


def moe_share(torch, cfg, params, x, busy_ms) -> str:
    """One layer's ``moe_apply`` on ``x`` (the forward's hidden states at
    one layer) profiled alone, times the model's MoE layers, as a share of
    a forward's device-busy ``busy_ms``; beside it the time the expert
    weights of those layers take to read once at 3.35 TB/s."""
    from repro_torch.models.moe import moe_apply

    key = next(f"l{i}" for i, (_, f) in enumerate(cfg.unit_pattern)
               if f == "moe")
    lp = {k: v[0] for k, v in params["units"][key].items()}
    _, one_ms, n, _ = profiled(torch, lambda: moe_apply(x, lp, cfg), reps=5)
    layers = moe_layers(cfg)
    nbytes = layers * sum(lp[k].numel() * lp[k].element_size()
                          for k in ("w_gate", "w_up", "w_down"))
    read_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (f"MoE {one_ms:.3f} ms device busy a layer ({n:.0f} kernels) x "
            f"{layers} layers = {one_ms * layers:.3f} ms "
            f"({one_ms * layers / busy_ms:.3f} of busy; reading its "
            f"{nbytes / 1e9:.2f} GB of expert weights once takes "
            f"{read_ms:.3f} ms at 3.35 TB/s)")


def moe_decode(torch, be, fn, busy_ms, top) -> None:
    """The MoE model's decode forward ``fn`` (64 rows; profiled, its
    device-busy ``busy_ms`` and kernels ``top``): the device time of its
    MoE layers, its largest copy kernels, and the memory one call takes
    beyond what is allocated before it (a permuted copy of one expert
    weight would add 11.3 GB at kimi-k2's width).  Resets the peak memory
    statistics."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((64, 1, be.cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    print("    " + moe_share(torch, be.cfg, be.params, x, busy_ms))
    copies = [(ms, count, key) for ms, count, key in top
              if "copy" in key.lower()]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    print("    largest copy kernels: " + ("; ".join(
        f"{ms:.4f} ms x{count} {key[:80]}" for ms, count, key in copies[:3])
        or "none") + f"; one forward allocates {extra / 2**30:.3f} GiB "
          "beyond the resident weights, pools and buffers")
    check(extra < 4 * 2**30, f"a decode forward allocates {extra} B: a copy "
          "of an expert weight?")


def kimi_serving(torch, pa, card) -> dict:
    """The MoE serving phase: kimi-k2 at full width, its depth cut to
    ``KIMI_LAYERS``, through ``PagedTorchBackend`` on the capped workload,
    one backend reused across runs (two do not fit the card): gmg fused
    n=1, fused n=4 and unfused n=1 with equal digests; after the first,
    batch invariance, verify logits bitwise decode logits, the decode and
    verify forwards' profiles and the MoE's share; then vllm with motif
    prompts at spec 0, spec 4 and spec 4 with the spec-0 run's streams
    replayed as drafts (accepted), with equal digests.  Returns the paged
    kernels' launches on the runs that take them."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.convert import tree_leaves
    from repro_torch.serving.torch_backend import ROWS, PagedTorchBackend

    t0 = time.perf_counter()
    full = get_config(KIMI)
    cfg = dataclasses.replace(full, num_layers=KIMI_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    be = PagedTorchBackend(config=cfg, **{
        k: v for k, v in SERVE_KW.items() if k not in ("arch", "reduced")})
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(be.params))
    print(f"serving {KIMI} at full width (d {cfg.d_model}, H "
          f"{cfg.num_heads}, KV {cfg.num_kv_heads}, Dh "
          f"{cfg.resolved_head_dim}, {cfg.num_experts} routed experts top-"
          f"{cfg.top_k} + {cfg.num_shared_experts} shared, d_ff_expert "
          f"{cfg.d_ff_expert}, vocab {cfg.vocab_size}; bf16, random weights "
          f"from seed 0), depth CUT to {KIMI_LAYERS} of {full.num_layers} "
          f"layers ({nbytes / 1e9:.2f} GB of weights; depth 2 would not fit "
          f"80 GB with the lm_head's f32 copy, the pools and the "
          f"activations); built in {time.perf_counter() - t0:.2f} s:")
    check(be.device.type == "cuda" and cfg.d_model == 7168
          and cfg.num_heads == 64 and cfg.num_kv_heads == 8
          and cfg.resolved_head_dim == 128 and cfg.num_experts == 384
          and cfg.top_k == 8 and cfg.num_shared_experts == 1
          and cfg.d_ff_expert == 2048 and cfg.vocab_size == 163840
          and cfg.dtype == "bfloat16" and be.model.supports_paged(),
          "full-width kimi-k2 config on the card")
    counts, digests, peak = {}, {}, 0
    for label, kw in (("fused n=1", {}), ("fused n=4", dict(decode_steps=4)),
                      ("unfused n=1", dict(fused=False))):
        _, _, counts[label], digests[label] = serve(torch, pa, be=be, **kw)
        if label == "fused n=1":
            invariant = batch_invariance(torch, be, ROWS)
            check(invariant["fixed"], "kimi-k2: results depend on the batch "
                  "grouping or the prefill chunking")
            verify_vs_decode(torch, be, ROWS)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            decode_breakdown(torch, be)     # resets the peak statistics
    print(f"  gmg digests: fused n=1 {digests['fused n=1']}, fused n=4 "
          f"{digests['fused n=4']}, unfused n=1 {digests['unfused n=1']}")
    check(len(set(digests.values())) == 1, "kimi-k2: the gmg token streams "
          "differ across fused / unfused / decode_steps")
    check(counts["fused n=1"]["fused_decode_attention"] > 0,
          "kimi-k2: fused_decode_attention never launched")
    check(counts["unfused n=1"]["paged_attention"] > 0,
          "kimi-k2: paged_attention never launched on the fused=False run")
    spec = {}
    for label, kw in (("spec 0", dict(spec=0)), ("spec 4", dict(spec=4)),
                      ("spec 4 replayed", dict(spec=4))):
        if label == "spec 4 replayed":
            kw["drafter"] = replay
        _, spec[label], counts[label], digests[label] = serve(
            torch, pa, be=be, scheduler="vllm", prompts=motif_prompts, **kw)
        if label == "spec 0":
            replay = replay_of(be, motif_prompts)
    print(f"  vllm digests: spec 0 {digests['spec 0']}, spec 4 "
          f"{digests['spec 4']}, spec 4 replayed drafts "
          f"{digests['spec 4 replayed']}; n-gram drafts accepted "
          f"{spec['spec 4'].spec_accepted} of {spec['spec 4'].spec_proposed}"
          f", replayed {spec['spec 4 replayed'].spec_accepted} of "
          f"{spec['spec 4 replayed'].spec_proposed}")
    check(digests["spec 4"] == digests["spec 0"]
          and digests["spec 4 replayed"] == digests["spec 0"],
          "kimi-k2: speculation changed the vllm token streams")
    check(spec["spec 4"].spec_proposed > 0, "kimi-k2: no draft proposed")
    check(spec["spec 4 replayed"].spec_accepted > 0,
          "kimi-k2: no replayed draft was accepted")
    check(counts["spec 4"]["fused_verify_attention"] > 0
          and counts["spec 4 replayed"]["fused_verify_attention"] > 0,
          "kimi-k2: fused_verify_attention never launched")
    torch.cuda.synchronize()
    peak = max(peak, torch.cuda.max_memory_allocated())
    del be
    torch.cuda.empty_cache()
    print(f"  kimi-k2 phase: {time.perf_counter() - t0:.2f} s wall, peak "
          f"allocated {peak / 2**30:.2f} GiB ({card})")
    return {"fused_decode_attention":
            counts["fused n=1"]["fused_decode_attention"],
            "paged_attention": counts["unfused n=1"]["paged_attention"],
            "fused_verify_attention":
            counts["spec 4"]["fused_verify_attention"]}


def flash_inputs(torch, B, S, H, KV, Dk, Dv, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            getattr(torch, dtype))

    return rnd(B, S, H, Dk), rnd(B, S, KV, Dk), rnd(B, S, KV, Dv)


def ptxas_entries(log, pattern):
    """(match of ``pattern`` in the mangled name, registers, spill line) of
    each kernel instance in a build's ``-Xptxas -v`` report whose name
    matches."""
    entry, found = None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = re.search(pattern, line)
            spills = ""
        elif entry and "spill" in line:
            spills = line.strip()
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            found.append((entry, regs, spills))
            entry = None
    return found


def ptxas_report(log, fa) -> None:
    """Registers and spills of each bf16 flash kernel instance, from the
    build's ``-Xptxas -v`` report, beside its dynamic shared memory.  An
    instance holds QP panels of 64 Dk columns and VP of 64 Dv columns, and
    stores the log-sum-exp for the backward or not."""
    for m, regs, spills in ptxas_entries(
            log, r"flash_wgmma_kernelILi(\d)ELi(\d)ELb([01])E"):
        qp, vp = int(m.group(1)), int(m.group(2))
        lse = " with the lse store" if m.group(3) == "1" else ""
        print(f"  flash_wgmma_kernel<{qp}, {vp}>{lse} (Dk <= {64 * qp}, Dv "
              f"<= {64 * vp}): {regs} registers, {spills}, dynamic shared "
              f"memory {fa.smem_bytes(64 * qp, 64 * vp)} B, 128 threads")
    check(log == "" or "flash_wgmma_kernel" in log,
          "no bf16 flash kernel in the build's ptxas report")


def paged_ptxas_report(log, pa) -> None:
    """Registers and spills of each instance of the paged kernels' body
    (element type; 16-byte cp.async copies or plain ones; decode/verify or
    attend only), beside its dynamic shared memory and blocking at the
    decode shape (W=1, G=8, D=64, capacity 256), the verify serving shape
    (W=5) and MQA's (W=9, G=32, D=128), where the host's shared memory and
    chunk length agree with the kernel's own."""
    lib = pa._kernels()
    check(lib.paged_chunk_tokens() == pa.CHUNK, "chunk length: the host and "
          "the kernel disagree")
    for m, regs, spills in ptxas_entries(
            log, r"paged_kernelI(13__nv_bfloat16|f)Lb([01])ELb([01])E"):
        elem = 2 if m.group(1) != "f" else 4
        shapes = []
        for W, G, D in ((1, 8, 64), (5, 8, 64), (9, 32, 128)):
            per, groups, chunks, nbytes, part = pa.blocking(W, G, D, elem,
                                                            16, 16)
            check(nbytes == lib.fused_verify_smem_bytes(per, D, elem == 2),
                  "shared memory: the host and the kernel disagree")
            shapes.append(f"{nbytes} B at W={W} G={G} D={D} ({groups} "
                          f"groups of {per} tasks x {chunks} chunks, "
                          f"{part} B of partials per lane and kv-head)")
        print(f"  paged_kernel<{'bf16' if elem == 2 else 'f32'}, "
              f"{'cp.async' if m.group(2) == '1' else 'plain copies'}, "
              f"{'fused' if m.group(3) == '1' else 'attend only'}>: {regs} "
              f"registers, {spills}, dynamic shared memory "
              + "; ".join(shapes) + f", 256 threads, {pa.CHUNK}-token "
              "chunks")
    check(log == "" or "paged_kernel" in log,
          "no paged kernel in the build's ptxas report")


def check_flash(torch, fa) -> tuple:
    """The flash kernel against its plain version at every case of
    ``FLASH_SWEEP``, ``FLASH_MAIN``, ``FLASH_FAMILY`` and
    ``FLASH_FAMILY_F32``, within the reference's tolerances (3e-5 f32,
    2.5e-2 bf16; ``tests/test_kernels.py``).  Returns the largest
    difference at the full-sequence models' shapes, by (Dk, Dv), and at
    each recurrent or frontend family's main-path shape, by arch."""
    family = {(*shape, "bfloat16", True): arch
              for arch, shape in FLASH_FAMILY.items()}
    worst, family_err = {}, {}
    for i, case in enumerate(FLASH_SWEEP + FLASH_MAIN + list(family)
                             + FLASH_FAMILY_F32):
        B, S, H, KV, Dk, Dv, dtype, causal = case
        q, k, v = flash_inputs(torch, B, S, H, KV, Dk, Dv, dtype, 600 + i)
        out = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 3e-5 if dtype == "float32" else 2.5e-2
        label = (f"{dtype} {'causal' if causal else 'full'} B={B} S={S} "
                 f"H={H} KV={KV} Dk={Dk} Dv={Dv}")
        print(f"  {label}: flash_attention max|diff| {err:.3e} "
              f"(tolerance {tol:g})")
        check(tuple(out.shape) == (B, S, H, Dv) and err <= tol,
              f"flash_attention {label}: {err} > {tol}")
        if case in FLASH_MAIN:
            worst[Dk, Dv] = max(worst.get((Dk, Dv), 0.0), err)
        if case in family:
            family_err[family[case]] = err
    return worst, family_err


def check_flash_mask(torch, fa) -> None:
    """Causality of the bf16 kernel on the card, at each bf16 prefill shape
    (one sequence): K/V changed at positions past i leave rows 0..i
    bitwise equal; changed at i too, rows before i stay equal and row i
    changes in every head.  i inside a 64-key tile, on its last key and on
    the first key of the next."""
    bf16 = [c for c in FLASH_MAIN if c[6] == "bfloat16"]
    for seed, (B, S, H, KV, Dk, Dv, _, _) in enumerate(bf16):
        q, k, v = flash_inputs(torch, 1, S, H, KV, Dk, Dv, "bfloat16",
                               800 + seed)
        _, k_new, v_new = flash_inputs(torch, 1, S, H, KV, Dk, Dv,
                                       "bfloat16", 900 + seed)
        out = fa.flash_attention(q, k, v)
        for i in (100, 127, 128, S - 2):
            k2, v2 = k_new.clone(), v_new.clone()
            k2[:, :i + 1], v2[:, :i + 1] = k[:, :i + 1], v[:, :i + 1]
            later = fa.flash_attention(q, k2, v2)
            k2[:, i] += 1
            v2[:, i] += 1
            at_i = fa.flash_attention(q, k2, v2)
            torch.cuda.synchronize()
            kept = torch.equal(later[:, :i + 1], out[:, :i + 1])
            kept_i = torch.equal(at_i[:, :i], out[:, :i])
            moved = bool((at_i[:, i] != out[:, i]).any(dim=-1).all())
            print(f"  bf16 causal S={S} H={H} KV={KV} Dk={Dk} Dv={Dv}, "
                  f"i={i}: rows 0..i equal after K/V past i changed: "
                  f"{kept}; rows before i equal and row i changed in every "
                  f"head after K/V at i changed: {kept_i and moved}")
            check(kept and kept_i and moved, f"flash_attention causal mask "
                  f"at i={i}, Dk={Dk}")


def fullseq(torch, fa, arch) -> int:
    """One full-width model's full-sequence forward (random bf16 weights
    from seed 0).  In f32 (copies of those weights, so the tolerance speaks
    of the algorithm; the first ``F32_LAYERS[arch]`` layers where the whole
    depth does not fit in f32): ``decode_step`` after ``prefill`` of S-1
    tokens equals ``logits`` at S-1 within the reference's rtol = atol =
    2e-2 (``tests/test_models_smoke.py``), one flash launch per layer per
    forward, and for tinyllama the paged path's (``prefill_paged`` +
    fused ``decode_paged``) logits equal too.  In bf16 at full depth, the
    main path: ``make_prefill_step`` then ``make_serve_step`` for
    ``GREEDY_STEPS`` greedy tokens, flash launches counted from 0 just
    before and read just after; then one profiled prefill forward (with
    the MoE layers' share, where the model has them).  Returns the main
    path's flash launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.convert import tree_map
    from repro_torch.models.model import build_model

    t_arch = time.perf_counter()
    (B, S), (Bs, Ss) = FULLSEQ[arch]
    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16", f"{arch} serves in bf16")
    L = F32_LAYERS.get(arch, cfg.num_layers)
    model, prefill_step = make_prefill_step(cfg)
    _, serve_step = make_serve_step(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    m32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                          num_layers=L))
    units = m32.cfg.num_units          # the f32 copy of the first L layers
    p32 = dict(tree_map(lambda t: t.float(), {
        k: v for k, v in params.items() if k != "units"}),
        units=tree_map(lambda t: t[:units].float(), params["units"]))
    if L < cfg.num_layers:
        print(f"  {arch}: the f32 checks run its first {L} of "
              f"{cfg.num_layers} layers (depth CUT: the whole depth in f32 "
              "would not fit beside the bf16 weights); the bf16 main path "
              "runs all of them")
    g = torch.Generator(device="cuda").manual_seed(1)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             device="cuda", dtype=torch.int32)

    def grown(m, caches, b, s):
        out = m.init_caches(b, s, "cuda")
        tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)]
                 .copy_(c), out, caches)
        return out

    toks = tokens(B, S)
    counts = [fa.launches["flash_attention"]]
    full = m32.logits(p32, {"tokens": toks})
    counts.append(fa.launches["flash_attention"])
    _, caches = m32.prefill(p32, {"tokens": toks[:, :S - 1]})
    counts.append(fa.launches["flash_attention"])
    dec, _ = m32.decode_step(p32, grown(m32, caches, B, S), toks[:, S - 1:],
                             S - 1)
    counts.append(fa.launches["flash_attention"])
    torch.cuda.synchronize()
    per = [b - a for a, b in zip(counts, counts[1:])]
    diff = (dec - full[:, S - 1]).abs().max().item()
    print(f"  {arch} f32 B={B} S={S}: decode_step after prefill vs logits "
          f"at S-1: max|diff| {diff:.3e}; flash launches per forward "
          f"(logits, prefill, decode_step) {per}")
    check(bool(torch.isfinite(full).all())
          and tuple(full.shape) == (B, S, cfg.vocab_size), "f32 logits")
    check(bool(torch.allclose(dec, full[:, S - 1], rtol=2e-2, atol=2e-2)),
          f"{arch}: decode_step differs from logits at S-1")
    check(per == [L, L, 0], f"{arch}: flash launches {per}, want "
          f"[{L}, {L}, 0]")
    if model.supports_paged():
        page = 16
        n_max = -(-S // page)
        pages = m32.init_paged_caches(B * n_max + 1, page, "cuda")
        tables = torch.arange(B * n_max, dtype=torch.int32,
                              device="cuda").view(B, n_max)
        for b in range(B):
            pages = m32.prefill_paged(p32, pages, toks[b:b + 1, :S - 1], 0,
                                      tables[b], S - 1)
        paged, _ = m32.decode_paged(
            p32, pages, toks[:, S - 1:].contiguous(),
            torch.full((B,), S - 1, dtype=torch.int32, device="cuda"),
            tables, fused=True)
        torch.cuda.synchronize()
        pdiff = (paged - dec).abs().max().item()
        print(f"  {arch} f32: paged path (prefill_paged + fused "
              f"decode_paged) vs decode_step logits: max|diff| {pdiff:.3e}")
        check(bool(torch.allclose(paged, dec, rtol=2e-2, atol=2e-2)),
              f"{arch}: paged logits differ from decode_step logits")
        del pages
    stoks = tokens(Bs, Ss)
    # the bf16 prefill's logits against f32 ones, where the f32 copy has
    # the whole depth
    ref32 = (m32.prefill(p32, {"tokens": stoks})[0]
             if L == cfg.num_layers else None)
    del p32, full, caches, dec
    torch.cuda.empty_cache()

    # the main path, in the serving dtype
    fa.launches["flash_attention"] = 0
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, {"tokens": stoks})
    first = logits
    caches = grown(model, caches, Bs, Ss + GREEDY_STEPS)
    out = []
    for i in range(GREEDY_STEPS):
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        out.append(nxt)
        logits, caches = serve_step(params, caches, nxt, Ss + i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches["flash_attention"]
    toks_out = torch.cat(out, dim=1).cpu().tolist()
    digest = hashlib.sha256(repr(toks_out).encode()).hexdigest()[:16]
    bdiff = ("not compared (the f32 copy is depth-cut)" if ref32 is None
             else f"{(first - ref32).abs().max().item():.3e}")
    print(f"  {arch} bf16 B={Bs} S={Ss}: make_prefill_step + "
          f"{GREEDY_STEPS} make_serve_step greedy tokens in {wall:.3f} s "
          f"wall, flash launches {launches}, token digest {digest}, "
          f"prefill logits vs f32 max|diff| {bdiff}")
    check(launches == cfg.num_layers, f"{arch}: {launches} flash launches "
          f"on the main path, want {cfg.num_layers}")
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (Bs, cfg.vocab_size)
          and all(0 <= t < cfg.vocab_size for r in toks_out for t in r),
          f"{arch}: serving logits / tokens")
    del caches, logits, first, ref32
    torch.cuda.empty_cache()

    wall_ms, busy_ms, n, top = profiled(
        torch, lambda: prefill_step(params, {"tokens": stoks}), reps=5)
    moe = ""
    if moe_layers(cfg):
        x = params["embed"][stoks.long()]
        moe = "; " + moe_share(torch, cfg, params, x, busy_ms)
    flash = [(ms, key) for ms, _, key in top if "flash_wgmma_kernel" in key]
    flash_ms = sum(ms for ms, _ in flash)
    check(busy_ms > 0 and flash_ms > 0,
          f"{arch}: the profiler saw no device time of the bf16 flash "
          "kernel (flash_wgmma_kernel)")
    print(f"  {arch} bf16 prefill forward B={Bs} S={Ss}: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), {n:.0f} kernels, flash kernel "
          f"{flash_ms:.3f} ms ({flash_ms / busy_ms:.3f} of busy) as "
          + ", ".join(key[:100] for _, key in flash) + moe)
    for ms, count, key in top[:8]:
        print(f"    {ms:.4f} ms x{count} {key[:90]}")
    del params, model
    torch.cuda.empty_cache()
    print(f"  {arch}: {time.perf_counter() - t_arch:.2f} s wall")
    return launches


def flash_times(torch, fa, flush) -> dict:
    """The flash kernel at the six prefill shapes (bf16, causal): kernel,
    plain version and one SDPA call on (B, H, S, D) with K/V expanded to H
    heads beforehand, medians of CUDA events with the L2 flushed.  The
    bound is that of what the bf16 kernel computes: q·k and p·v (p rounded
    to bf16) both at the tensor cores' 989 TFLOP/s against the bytes at
    3.35 TB/s; the bound with p·v on f32 probabilities at the 67 TFLOP/s
    of the CUDA cores (what the f32 body computes) is printed beside it.
    Returns {arch: (ms, plain_ms, library_ms, bound_ms, bound_by)}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    shapes = {"tinyllama-1.1b": (4, 1024, 32, 4, 64, 64),
              "minicpm3-4b": (2, 1024, 40, 40, 96, 64),
              "deepseek-v2-lite-16b": (2, 1024, 16, 16, 192, 128),
              **FLASH_FAMILY}
    for i, (arch, (B, S, H, KV, Dk, Dv)) in enumerate(shapes.items()):
        q, k, v = flash_inputs(torch, B, S, H, KV, Dk, Dv, "bfloat16",
                               700 + i)
        ms = median_ms(torch, lambda: fa.flash_attention(q, k, v), flush)
        plain_ms = median_ms(torch, lambda: fa.flash_attention_ref(q, k, v),
                             flush)
        G = H // KV
        qs = q.transpose(1, 2).contiguous()
        ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        lib_ms = median_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True),
                           flush)
        pairs = S * (S + 1) // 2             # causal (query, key) pairs
        qk, pv = 2 * B * H * Dk * pairs, 2 * B * H * Dv * pairs
        nbytes = 2 * B * S * (H * Dk + KV * Dk + KV * Dv + H * Dv)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (qk + pv) / BF16_FLOPS * 1e3
        t_f32p = (qk / BF16_FLOPS + pv / F32_FLOPS) * 1e3
        bound_ms = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  {arch} B={B} S={S} H={H} KV={KV} Dk={Dk} Dv={Dv}: kernel "
              f"{ms:.4f} ms, bound {bound_ms:.5f} ms by {by} (q.k "
              f"{qk / 1e9:.3f} + p.v {pv / 1e9:.3f} GFLOP at 989 bf16 "
              f"TFLOP/s = {t_ops:.5f} ms; {nbytes} B / 3.35 TB/s = "
              f"{t_bytes:.5f} ms; with p.v on f32 probabilities at 67 f32 "
              f"TFLOP/s the bound would be {max(t_bytes, t_f32p):.5f} ms), "
              f"{bound_ms / ms:.3f} of the bound, plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms")
        rows[arch] = (ms, plain_ms, lib_ms, bound_ms, by)
    return rows


# ---------------------------------------------------------------------------
# the recurrent and frontend families: jamba (mamba + attention + MoE),
# xlstm (mLSTM + sLSTM), musicgen (audio frames, sinusoidal positions),
# pixtral (vision patches)
# ---------------------------------------------------------------------------
def attn_layers(cfg) -> int:
    """Number of attention layers of ``cfg`` (one flash launch each per
    forward, one backward launch each per gradient pass)."""
    return (sum(m == "attn" for m, _ in cfg.prefix_pattern)
            + cfg.num_units * sum(m == "attn" for m, _ in cfg.unit_pattern))


def family_batch(torch, model, B, S, g, labels=True):
    """A batch of S positions on the card with the keys, shapes and dtypes
    of ``model.input_specs`` (int32 tokens and labels uniform over the
    vocabulary, frames and patches normal in the model dtype)."""
    from repro_torch.configs.shapes import Shape

    specs = model.input_specs(
        Shape("family", S, B, "train" if labels else "prefill"))["batch"]
    return {k: torch.randint(0, model.cfg.vocab_size, m.shape, generator=g,
                             device="cuda", dtype=m.dtype)
            if m.dtype == torch.int32 else
            torch.randn(m.shape, generator=g, device="cuda").to(m.dtype)
            for k, m in specs.items()}


def mixers_vs_cpu(torch, cfg, params) -> None:
    """Each recurrent mixer of ``cfg`` at full width (its first layer, f32
    weights ``params``) on the card against the CPU on the same weights and
    input (B=1, S=256, TF32 off): the prefill output and state, then one
    decode step's output and state, each within ``MIXER_RTOL`` of the
    tensor's largest CPU value."""
    from repro_torch.models.convert import tree_leaves, tree_map
    from repro_torch.models.transformer import MIXERS

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 257, cfg.d_model), generator=g, device="cuda")
    for mixer in ("mamba", "mlstm", "slstm"):
        key = next((f"l{i}" for i, (m, _) in enumerate(cfg.unit_pattern)
                    if m == mixer), None)
        if key is None:
            continue
        fn = MIXERS[mixer]
        lp = {k: v[0] for k, v in params["units"][key].items()}
        lp_cpu = {k: v.cpu() for k, v in lp.items()}
        outs = []
        for p, d in ((lp, "cuda"), (lp_cpu, "cpu")):
            xd = x.to(d)
            y, cache = fn(xd[:, :256], p, cfg, "prefill")
            state = tree_map(torch.clone, cache)
            y1, _ = fn(xd[:, 256:], p, cfg, "decode", cache=cache)
            outs.append([y, *tree_leaves(state), y1, *tree_leaves(cache)])
        torch.cuda.synchronize()
        worst = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(*outs))
        print(f"  {cfg.name} {mixer} layer f32 card vs CPU (B=1 S=256 "
              f"prefill, then a decode step; d {cfg.d_model}): max|card - "
              f"CPU| {worst:.3e} of each tensor's largest CPU value "
              f"(tolerance {MIXER_RTOL:g})")
        check(worst <= MIXER_RTOL, f"{cfg.name} {mixer}: card vs CPU "
              f"{worst:.3e}")


def mixer_share(torch, cfg, params, x, busy_ms, mixer) -> str:
    """One ``mixer`` layer's prefill on ``x`` profiled alone, times the
    model's layers of that mixer, as a share of a forward's device-busy
    ``busy_ms`` (None: a forward that was not profiled)."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import MIXERS

    key = next(f"l{i}" for i, (m, _) in enumerate(cfg.unit_pattern)
               if m == mixer)
    lp = {k: v[0] for k, v in params["units"][key].items()}
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    slow = mixer == "slstm"               # a kernel per op per step of S
    _, one_ms, n, _ = profiled(
        torch, lambda: MIXERS[mixer](h, lp, cfg, "prefill"),
        reps=1 if slow else 5, warmup=1, cpu=False)
    layers = cfg.num_units * sum(m == mixer for m, _ in cfg.unit_pattern)
    share = ("" if busy_ms is None
             else f" ({one_ms * layers / busy_ms:.3f} of busy)")
    return (f"{mixer} {one_ms:.3f} ms device busy a layer ({n:.0f} kernels)"
            f" x {layers} = {one_ms * layers:.3f} ms{share}")


def family(torch, fa, arch, card) -> int:
    """One recurrent or frontend family at full width (random weights from
    seed 0; depths and shapes from ``RECURRENT``).  In f32 at the check
    depth: ``decode_step`` for two tokens after ``prefill`` of S-2
    positions equals ``logits`` at S-2 and S-1 within the reference's
    rtol = atol = 2e-2 (for audio frames the last two frames are the
    decoded tokens' embeddings), one flash launch per attention layer per
    forward; each recurrent mixer on the card against the CPU
    (``mixers_vs_cpu``).  In bf16 at the check depth, one gradient pass of
    ``Model.loss`` (B=1): the loss finite, every gradient slice finite and
    non-zero but those of leaves the loss does not read, one flash
    backward launch per attention layer.  In bf16 at the main depth, the
    main path: ``make_prefill_step`` then ``make_serve_step`` for
    ``GREEDY_STEPS`` greedy tokens, flash launches counted from 0 just
    before and read just after (one per attention layer); then one
    profiled prefill forward (flash, each mixer's and the MoE's shares)
    and one profiled decode step.  Each stage's weights are drawn anew and
    freed after it.  Returns (the main path's flash launches, the peak
    memory allocated)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          value_and_grad)
    from repro_torch.models.convert import tree_map
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (Bm, Sm), depth, check_depth, (B, S) = RECURRENT[arch]
    full = get_config(arch)
    check(full.dtype == "bfloat16", f"{arch} serves in bf16")
    mixers = sorted({m for m, _ in full.unit_pattern})
    cut = (f"depth CUT to {depth} of {full.num_layers}"
           if depth < full.num_layers else f"full depth {depth}")
    print(f"  {arch} (d {full.d_model}, {mixers} mixers, frontend "
          f"{full.frontend}, positional {full.positional}, vocab "
          f"{full.vocab_size}): bf16 main path {cut}; f32 checks and the "
          f"gradient pass at depth {check_depth}")

    # f32 at the check depth
    m32 = build_model(dataclasses.replace(full, dtype="float32",
                                          num_layers=check_depth))
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = family_batch(torch, m32, B, S, g, labels=False)
    toks = torch.randint(0, full.vocab_size, (B, 2), generator=g,
                         device="cuda", dtype=torch.int32)
    if full.frontend == "audio_frames":
        batch["frames"][:, S - 2:] = p32["embed"][toks.long()]
        pre = {"frames": batch["frames"][:, :S - 2]}
    else:
        batch["tokens"][:, -2:] = toks
        pre = dict(batch, tokens=batch["tokens"][:, :-2])
    counts = [fa.launches["flash_attention"]]
    full_logits = m32.logits(p32, batch)
    counts.append(fa.launches["flash_attention"])
    _, caches = m32.prefill(p32, pre)
    counts.append(fa.launches["flash_attention"])
    grown = m32.init_caches(B, S, "cuda")
    tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)].copy_(c),
             grown, caches)
    diffs = []
    for i in range(2):
        dec, _ = m32.decode_step(p32, grown, toks[:, i:i + 1], S - 2 + i)
        diffs.append((dec - full_logits[:, S - 2 + i]).abs().max().item())
        check(bool(torch.allclose(dec, full_logits[:, S - 2 + i], rtol=2e-2,
                                  atol=2e-2)),
              f"{arch}: decode step {i + 1} differs from logits")
    counts.append(fa.launches["flash_attention"])
    torch.cuda.synchronize()
    per = [b - a for a, b in zip(counts, counts[1:])]
    n32 = attn_layers(m32.cfg)
    print(f"  {arch} f32 depth {check_depth} B={B} S={S}: two decode_steps "
          f"after prefill of S-2 vs logits at S-2, S-1: max|diff| "
          + ", ".join(f"{d:.3e}" for d in diffs) + f"; flash launches per "
          f"forward (logits, prefill, two decode_steps) {per}")
    check(bool(torch.isfinite(full_logits).all()) and tuple(
        full_logits.shape) == (B, S, full.vocab_size), f"{arch}: f32 logits")
    check(per == [n32, n32, 0], f"{arch}: flash launches {per}, want "
          f"[{n32}, {n32}, 0]")
    mixers_vs_cpu(torch, m32.cfg, p32)
    stages = {"f32 checks": time.perf_counter() - t0}
    # the model too: it keeps its lm_head's f32 copy (here the head itself)
    del p32, full_logits, caches, grown, dec, m32
    torch.cuda.empty_cache()

    # bf16 gradient pass at the check depth, B=1
    mg = build_model(dataclasses.replace(full, num_layers=check_depth))
    params = mg.init(torch.Generator(device="cuda").manual_seed(0))
    gbatch = family_batch(torch, mg, 1, S, g)
    before = fa.launches["flash_attention_bwd"]
    loss, grads = value_and_grad(mg.loss, params, gbatch)
    torch.cuda.synchronize()
    launched = fa.launches["flash_attention_bwd"] - before
    # the loss of audio frames never reads the token embeddings (decode
    # alone does)
    unread = {"embed"} if full.frontend == "audio_frames" else set()
    read = [(n, gr) for n, gr, _ in grad_slices(grads) if n not in unread]
    zero = [n for n, gr in read if not (
        bool(torch.isfinite(gr).all()) and bool(gr.abs().sum() > 0))]
    print(f"  {arch} bf16 gradient pass, depth {check_depth}, B=1 S={S}: "
          f"loss {loss.item():.6f}; {len(read)} gradient slices read by "
          f"the loss, finite and non-zero: {len(read) - len(zero)}"
          + (f" (not read: {sorted(unread)})" if unread else "")
          + f"; flash backward launches {launched}")
    check(math.isfinite(loss.item()), f"{arch}: non-finite loss")
    check(not zero, f"{arch}: zero or non-finite gradients: {zero}")
    check(launched == attn_layers(mg.cfg), f"{arch}: {launched} flash "
          f"backward launches, want {attn_layers(mg.cfg)}")
    del params, grads, gbatch, read, mg
    torch.cuda.empty_cache()
    stages["gradient pass"] = time.perf_counter() - t0 - sum(stages.values())

    # the main path, bf16 at the main depth
    cfg = dataclasses.replace(full, num_layers=depth)
    model, prefill_step = make_prefill_step(cfg)
    _, serve_step = make_serve_step(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    mbatch = family_batch(torch, model, Bm, Sm, g, labels=False)
    fa.launches["flash_attention"] = 0
    t1 = time.perf_counter()
    logits, caches = prefill_step(params, mbatch)
    grown = model.init_caches(Bm, Sm + GREEDY_STEPS, "cuda")
    tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)].copy_(c),
             grown, caches)
    del caches
    out = []
    for i in range(GREEDY_STEPS):
        nxt = logits.argmax(-1).to(torch.int32)[:, None]
        out.append(nxt)
        logits, grown = serve_step(params, grown, nxt, Sm + i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = fa.launches["flash_attention"]
    toks_out = torch.cat(out, dim=1).cpu().tolist()
    digest = hashlib.sha256(repr(toks_out).encode()).hexdigest()[:16]
    print(f"  {arch} bf16 B={Bm} S={Sm}: make_prefill_step + {GREEDY_STEPS} "
          f"make_serve_step greedy tokens in {wall:.3f} s wall, flash "
          f"launches {launches}, token digest {digest}")
    check(launches == attn_layers(cfg), f"{arch}: {launches} flash "
          f"launches on the main path, want {attn_layers(cfg)}")
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (Bm, full.vocab_size)
          and all(0 <= t < full.vocab_size for r in toks_out for t in r),
          f"{arch}: serving logits / tokens")

    stages["main path"] = time.perf_counter() - t0 - sum(stages.values())
    # one profiled prefill forward (for xlstm one layer of each mixer
    # alone: the profiler takes minutes over the sLSTM loop's 225k kernels
    # of a whole prefill) and one profiled decode step
    x = model._embed(params, mbatch, "prefill")
    if "slstm" in mixers:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_step(params, mbatch)            # the main path warmed it
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        print(f"  {arch} bf16 prefill forward B={Bm} S={Sm}: wall "
              f"{wall_ms:.3f} ms (one call, not profiled); "
              + "; ".join(mixer_share(torch, cfg, params, x, None, m)
                          for m in mixers if m != "attn"))
    else:
        wall_ms, busy_ms, n, top = profiled(
            torch, lambda: prefill_step(params, mbatch), cpu=False)
        shares = [mixer_share(torch, cfg, params, x, busy_ms, m)
                  for m in mixers if m != "attn"]
        if moe_layers(cfg):
            shares.append(moe_share(torch, cfg, params, x, busy_ms))
        flash_ms = sum(ms for ms, _, key in top
                       if "flash_wgmma_kernel" in key)
        print(f"  {arch} bf16 prefill forward B={Bm} S={Sm}: wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
              f"{1 - busy_ms / wall_ms:.3f}), {n:.0f} kernels, flash kernel "
              f"{flash_ms:.3f} ms ({flash_ms / busy_ms:.3f} of busy)"
              + "".join("; " + s for s in shares))
        for ms, count, key in top[:8]:
            print(f"    {ms:.4f} ms x{count} {key[:90]}")
    tok = out[-1]
    wall_ms, busy_ms, n, top = profiled(
        torch, lambda: serve_step(params, grown, tok, Sm + GREEDY_STEPS - 1),
        cpu=False)
    print(f"  {arch} bf16 decode step B={Bm} at position "
          f"{Sm + GREEDY_STEPS - 1}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{n:.0f} kernels")
    for ms, count, key in top[:5]:
        print(f"    {ms:.4f} ms x{count} {key[:90]}")
    del params, grown, logits, x, model
    torch.cuda.empty_cache()
    stages["profiles"] = time.perf_counter() - t0 - sum(stages.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"  {arch}: peak allocated {peak / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items())
          + f"; {card})")
    return launches, peak


# ---------------------------------------------------------------------------
# training: the flash backward kernel, the f32 step on the card against the
# CPU's, the main path at full width, the restart drill
# ---------------------------------------------------------------------------
def bwd_ptxas_report(log, fa) -> None:
    """Registers, spills and dynamic shared memory of each instance of the
    flash backward's kernels, from the build's ``-Xptxas -v`` report: the
    bf16 body's dK/dV and dQ kernels on wgmma (QP, VP panels of 64 Dk and
    Dv columns; the dK/dV kernel's query tile BQ) and the f32 body's FMA
    kernels (Dk, Dv)."""
    for m, regs, spills in ptxas_entries(
            log, r"(dkdv|dq)_(wgmma|fma)_kernel"
                 r"ILi(\d+)ELi(\d+)E(?:Li(\d+)E)?"):
        a, b = int(m.group(3)), int(m.group(4))
        if m.group(2) == "wgmma":
            pair = next(p for p in fa.BWD_HEAD_DIMS
                        if (p[0] + 63) // 64 == a and (p[1] + 63) // 64 == b)
            dims, threads = f"bf16, Dk <= {64 * a}, Dv <= {64 * b}", 128
        else:
            pair, dims, threads = (a, b), f"f32, Dk {a}, Dv {b}", 256
        smem = fa.bwd_smem_bytes(*pair, m.group(2) == "wgmma")[
            m.group(1) == "dq"]
        tile = f", {m.group(5)}" if m.group(5) else ""
        print(f"  {m.group(1)}_{m.group(2)}_kernel<{a}, {b}{tile}> ({dims}): "
              f"{regs} registers, {spills}, dynamic shared memory {smem} B, "
              f"{threads} threads")
    check(log == "" or all(f"{k}_{b}_kernel" in log for k in ("dkdv", "dq")
                           for b in ("wgmma", "fma")),
          "no flash backward kernels in the build's ptxas report")


def bwd_refs(fa, q, k, v, o, lse, do, causal=True):
    """The plain backward in f32 on f32 copies of the inputs, and, for
    bf16 inputs, its terms' root-sum-square (``fa.bwd_error``'s bound;
    None for f32)."""
    f = [t.float() for t in (q, k, v, o)] + [lse, do.float()]
    ref = fa.flash_attention_bwd_ref(*f, causal=causal)
    rss = (fa.flash_attention_bwd_rss(*f, causal=causal)
           if q.dtype != f[0].dtype else (None, None, None))
    return ref, rss


def bwd_tolerance(fa) -> str:
    return (f"tolerance f32 {fa.BWD_F32_RTOL:g} of the largest value; bf16 "
            f"2^-8 |ref| + 2^-6 rss + {fa.BWD_BF16_ATOL:g}, against the "
            "plain backward in f32")


def check_bwd_case(torch, fa, case, dtype, seed) -> tuple:
    """One backward case: the forward's lse against a plain logsumexp of
    the scores (1e-4), the kernel against ``flash_attention_bwd_ref`` on
    the same inputs, two calls bitwise equal.  Returns the largest
    difference of dq, dk, dv and the largest error as a fraction of its
    tolerance (``fa.bwd_error``); exits on a failed check."""
    B, S, H, KV, Dk, Dv, causal = case
    q, k, v = flash_inputs(torch, B, S, H, KV, Dk, Dv, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn((B, S, H, Dv), generator=g, device="cuda").to(
        getattr(torch, dtype))
    o, lse = fa._forward(q, k, v, causal, Dk ** -0.5, with_lse=True)
    lse_err = (lse - fa.flash_attention_lse_ref(q, k, causal=causal)).abs()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref, rss = bwd_refs(fa, q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    label = (f"{dtype} {'causal' if causal else 'full'} B={B} S={S} H={H} "
             f"KV={KV} Dk={Dk} Dv={Dv}")
    check(lse_err.max().item() <= 1e-4, f"flash lse {label}")
    fracs = [fa.bwd_error(a, r, e) for a, r, e in zip(got, ref, rss)]
    for name, a, b, r, f in zip(("dq", "dk", "dv"), got, again, ref, fracs):
        check(tuple(a.shape) == tuple(r.shape) and a.dtype == q.dtype
              and bool(torch.isfinite(a).all()), f"{name} {label}")
        check(torch.equal(a, b), f"flash backward {name} not repeatable, "
              f"{label}")
        check(f <= 1, f"flash backward {name} {label}: "
              f"{(a.float() - r.float()).abs().max().item()}, {f:.3f} of "
              "the tolerance")
    return max((a.float() - r.float()).abs().max().item()
               for a, r in zip(got, ref)), max(fracs)


def check_bwd_all(torch, fa) -> None:
    """The backward kernel over ``BWD_HEAD_DIMS`` x S in ``BWD_S`` x causal
    and full x f32 and bf16 x G in {1, 8}, a line per group of S; at the
    families' gradient-pass shapes (``FLASH_FAMILY_BWD``); then
    ``FlashAttentionFn`` (both kernels) against torch autograd through
    ``flash_attention_ref`` in f32.  (The training shape itself is checked
    in ``bwd_times``.)"""
    seed = 1000
    for Dk, Dv in sorted(fa.BWD_HEAD_DIMS):
        for dtype in ("float32", "bfloat16"):
            for G in (1, 8):
                for causal in (True, False):
                    errs = []
                    for S in BWD_S:
                        KV = 2 if G == 1 else 1
                        B = 2 if S <= 200 else 1
                        seed += 2
                        errs.append(check_bwd_case(
                            torch, fa, (B, S, G * KV, KV, Dk, Dv, causal),
                            dtype, seed))
                    print(f"  {dtype} {'causal' if causal else 'full'} "
                          f"Dk={Dk} Dv={Dv} G={G}, S {BWD_S}: dq/dk/dv "
                          f"max|diff| " + " ".join(f"{e:.2e}" for e, _ in errs)
                          + f", at most {max(f for _, f in errs):.3f} of the "
                          "tolerance; lse within 1e-4; two calls bitwise "
                          "equal")
    for i, (B, S, H, KV, Dk, Dv) in enumerate(FLASH_FAMILY_BWD):
        err, frac = check_bwd_case(torch, fa, (B, S, H, KV, Dk, Dv, True),
                                   "bfloat16", 1500 + 2 * i)
        print(f"  bfloat16 causal B={B} S={S} H={H} KV={KV} Dk={Dk} Dv={Dv}"
              f" (a family's gradient pass): dq/dk/dv max|diff| {err:.2e}, "
              f"{frac:.3f} of the tolerance; lse within 1e-4; two calls "
              "bitwise equal")
    print(f"  ({bwd_tolerance(fa)})")
    for Dk, Dv, causal in ((64, 64, True), (96, 64, False)):
        q, k, v = flash_inputs(torch, 2, 300, 8, 2, Dk, Dv, "float32", 77)
        do = torch.randn((2, 300, 8, Dv), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(78))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=causal)
        check(type(out.grad_fn).__name__ == "FlashAttentionFnBackward",
              "flash_attention with grad did not go through FlashAttentionFn")
        got = torch.autograd.grad(out, leaves, do)
        ref = torch.autograd.grad(
            fa.flash_attention_ref(*ref_leaves, causal=causal), ref_leaves,
            do)
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        print(f"  FlashAttentionFn f32 Dk={Dk} Dv={Dv} "
              f"{'causal' if causal else 'full'} B=2 S=300 H=8 KV=2: "
              f"gradients vs autograd through flash_attention_ref max|diff| "
              f"{err:.3e} (tolerance {fa.BWD_F32_RTOL:g} of the largest, at "
              "least 1)")
        check(all(fa.bwd_error(a, b) <= 1 for a, b in zip(got, ref)),
              "FlashAttentionFn gradients")


@contextlib.contextmanager
def plain_attention(fa):
    """While the block runs, the models' causal attention is autograd
    through ``flash_attention_ref`` (the plain version) on the card: the
    reference the kernels' bf16 gradients and loss curve are held
    against."""
    from repro_torch.models import attention
    kernel = attention.causal_attention
    attention.causal_attention = (
        lambda q, k, v, *, scale: fa.flash_attention_ref(
            q, k, v, causal=True, scale=scale))
    try:
        yield
    finally:
        attention.causal_attention = kernel


def _train_batches(torch, cfg, B, S, n=None):
    """``PackedLoader`` seed 0 batches on the card: a generator, or the
    first n as a list."""
    from repro_torch.data.pipeline import (DataConfig, PackedLoader,
                                           device_batches)
    it = device_batches(PackedLoader(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)),
        "cuda")
    return it if n is None else [next(it) for _ in range(n)]


def train_vs_cpu(torch, fa) -> None:
    """f32 tinyllama at full width, depth cut to ``CHECK_LAYERS``, B=2,
    S=256: the loss and every gradient on the card (flash forward and
    backward kernels) against the CPU's (plain versions), same weights and
    batch; every card gradient finite and non-zero (wq/wk/wv too: without
    ``FlashAttentionFn`` the kernel's output had no gradient); the
    ``make_train_step`` step's loss bitwise the gradient pass's."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.convert import tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              num_layers=CHECK_LAYERS)
    model, opt, step = make_train_step(cfg, lr=TRAIN_LR)
    cpu = model.init(torch.Generator().manual_seed(0))
    dev = tree_map(lambda t: t.to("cuda"), cpu)
    batch = _train_batches(torch, cfg, 2, 256, 1)[0]
    before = fa.launches["flash_attention_bwd"]
    loss, grads = value_and_grad(model.loss, dev, batch)
    torch.cuda.synchronize()
    launched = fa.launches["flash_attention_bwd"] - before
    ref_loss, ref = value_and_grad(model.loss, cpu, {
        k: t.cpu() for k, t in batch.items()})
    worst, names = 0.0, []

    def leaf(path, g, r):
        nonlocal worst
        g = g.cpu()
        check(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0),
              f"card gradient of {path} is not finite and non-zero")
        rel = ((g - r).abs().max() / r.abs().max()).item()
        worst = max(worst, rel)
        names.append(path)
        check(rel <= TRAIN_GRAD_RTOL, f"card gradient of {path}: "
              f"{rel:.3e} of its largest CPU value")

    for lay, d in grads["units"].items():
        for name, g in d.items():
            leaf(f"units/{lay}/{name}", g, ref["units"][lay][name])
    for name in ("embed", "final_norm", "lm_head"):
        leaf(name, grads[name], ref[name])
    _, _, step_loss = step(dev, opt.init(dev), batch)
    dl = abs(loss.item() - ref_loss.item())
    print(f"  f32 {TRAIN_ARCH} full width, depth CUT to {CHECK_LAYERS} of "
          f"22, B=2 S=256: loss card {loss.item():.6f} vs CPU "
          f"{ref_loss.item():.6f} (|diff| {dl:.2e}, tolerance 1e-5 x "
          f"loss); {len(names)} gradient leaves, each finite and non-zero "
          f"on the card (units/l0/wq/wk/wv among them), max|card - CPU| "
          f"{worst:.2e} of each leaf's largest CPU value (tolerance "
          f"{TRAIN_GRAD_RTOL:g}); {launched} flash backward launches; "
          f"make_train_step's loss bitwise the gradient pass's: "
          f"{torch.equal(step_loss, loss)}")
    check(dl <= 1e-5 * abs(ref_loss.item()), "card loss vs CPU loss")
    check(launched == CHECK_LAYERS, f"{launched} flash backward launches, "
          f"want {CHECK_LAYERS}")
    check(torch.equal(step_loss, loss), "make_train_step's loss is not the "
          "gradient pass's")
    check({"units/l0/wq", "units/l0/wk", "units/l0/wv"} <= set(names),
          "q/k/v gradients not checked")


def train_profile(torch, model, opt, params, state, batch):
    """One main-path step under the profiler: device busy time as the sum
    of the device's own rows (kernels, copies, fills), kernels sorted by
    name into the flash forward and backward and the bf16 and f32 GEMMs
    (the f32 ones are the lm_head's), the optimizer's update timed by
    CUDA events around it.  Returns
    (params, state, wall ms, busy ms, {share: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    events_opt = []

    def update(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = opt.update(*args)
        b.record()
        events_opt.append((a, b))
        return out

    from repro_torch.launch.train import make_accum_train_step
    prof_step = make_accum_train_step(
        model, dataclasses.replace(opt, update=update))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = prof_step(params, state, batch)
        loss.item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0.0)

    # the device's own rows (kernels, copies, fills): a CPU row's device
    # time is that of the kernels it launched, counted in their own rows
    kernels = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    shares = {"flash forward": 0.0, "flash backward": 0.0,
              "f32 GEMMs (lm_head)": 0.0, "bf16 GEMMs": 0.0}
    bwd_parts = {}
    for e in kernels:
        k, ms = e.key.lower(), dev_us(e) / 1e3
        part = re.search(r"(dkdv|dq)_(wgmma|fma)_kernel|delta_kernel", k)
        if "flash_wgmma_kernel" in k or "flash_kernel" in k:
            shares["flash forward"] += ms
        elif part:
            shares["flash backward"] += ms
            t, n = bwd_parts.get(part.group(0), (0.0, 0))
            bwd_parts[part.group(0)] = (t + ms, n + e.count)
        elif any(s in k for s in ("gemm", "xmma", "nvjet", "cutlass")):
            f32 = any(s in k for s in ("sgemm", "f32f32_f32f32", "simt",
                                       "fp32", "_s1688", "sm90_xmma_gemm_f32"))
            shares["f32 GEMMs (lm_head)" if f32 else "bf16 GEMMs"] += ms
    a, b = events_opt[0]
    shares["optimizer (CUDA events)"] = a.elapsed_time(b)
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    for e in top:
        print(f"    {dev_us(e) / 1e3:.3f} ms x{e.count} {e.key[:90]}")
    print("    flash backward by kernel: " + ", ".join(
        f"{n} {ms:.3f} ms x{c}" for n, (ms, c) in sorted(bwd_parts.items())))
    return params, state, wall_ms, busy, shares


def train_main(torch, fa, card) -> dict:
    """The main path: tinyllama-1.1b at full width and depth in bf16, remat
    on, AdamW, ``PackedLoader`` seed 0 at B=8, S=2048, ``TRAIN_STEPS``
    steps through ``make_accum_train_step``, flash launches counted from 0
    just before and read just after; the loss must fall.  Before them, one
    gradient pass on the first batch: every parameter leaf's gradient
    finite and non-zero (wq/wk/wv reach the loss only through the flash
    kernels).  After them, one profiled step.  Returns the flash forward
    and backward launches of the steps."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.launch.train import make_accum_train_step

    cfg = get_config(TRAIN_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.remat and cfg.optimizer == "adamw",
          f"{TRAIN_ARCH} trains in bf16 with remat and AdamW")
    B, S = TRAIN_SHAPE
    model, opt, _ = make_train_step(cfg, lr=TRAIN_LR)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = (opt.init(params), None)
    step_fn = make_accum_train_step(model, opt)
    batches = _train_batches(torch, cfg, B, S)
    first = next(batches)
    loss0, grads = value_and_grad(model.loss, params, first)
    # every leaf, and of a unit leaf every one of its 22 layers' slices
    nonzero = {name: bool(torch.isfinite(grads[name]).all())
               and bool(grads[name].abs().sum() > 0)
               for name in ("embed", "final_norm", "lm_head")}
    nonzero.update({f"units/l0/{n}": bool(torch.isfinite(g).all())
                    and bool((g.flatten(1).abs().sum(1) > 0).all())
                    for n, g in grads["units"]["l0"].items()})
    bf16_witness(torch, fa, model, params, first, loss0, grads)
    del grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches["flash_attention"] = fa.launches["flash_attention_bwd"] = 0
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = first if i == 0 else next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step_fn(params, state, batch)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    launches = {k: fa.launches[k] for k in ("flash_attention",
                                            "flash_attention_bwd")}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[2:])
    tokens = B * S
    n_dense = cfg.param_count() - cfg.vocab_size * cfg.d_model  # no embed
    pairs = S * (S + 1) // 2
    attn = 12 * cfg.num_layers * B * cfg.num_heads * cfg.resolved_head_dim \
        * pairs
    flops = 6 * n_dense * tokens + attn
    print(f"  {TRAIN_ARCH} bf16 full width and depth, remat, AdamW lr "
          f"{TRAIN_LR:g}, PackedLoader seed 0, B={B} S={S}: {TRAIN_STEPS} "
          f"steps through make_accum_train_step; step ms "
          + " ".join(f"{t * 1e3:.1f}" for t in times)
          + f"; median of steps 3..{TRAIN_STEPS} {med * 1e3:.3f} ms, "
          f"{tokens / med:.0f} tokens/s, model {flops / 1e12:.2f} TFLOP a "
          f"step (6 x {n_dense / 1e9:.3f}e9 non-embedding params x tokens "
          f"+ causal attention), {flops / med / 1e12:.1f} TFLOP/s = "
          f"{flops / med / BF16_FLOPS:.3f} of 989; peak allocated "
          f"{peak / 2**30:.2f} GiB; loss first {losses[0]:.4f} last "
          f"{losses[-1]:.4f} ({' '.join(f'{x:.3f}' for x in losses)}); "
          f"flash launches per step: forward "
          f"{launches['flash_attention'] / TRAIN_STEPS:g} (22 + 22 rerun by "
          f"remat), backward {launches['flash_attention_bwd'] / TRAIN_STEPS:g}"
          f"; a gradient pass before the steps: every leaf's gradient "
          f"(each of the 22 layers' for unit leaves) finite and non-zero: "
          f"{all(nonzero.values())} over {len(nonzero)} leaves ({card})")
    check(all(torch.isfinite(torch.tensor(losses))), "non-finite loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    check(all(nonzero.values()), "zero or non-finite gradients: "
          + ", ".join(k for k, ok in nonzero.items() if not ok))
    check(launches["flash_attention_bwd"] == cfg.num_layers * TRAIN_STEPS
          and launches["flash_attention"] == 2 * cfg.num_layers * TRAIN_STEPS,
          f"flash launches {launches}")
    params, state, wall_ms, busy, shares = train_profile(
        torch, model, opt, params, state, next(batches))
    print(f"  one profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}); "
          + ", ".join(f"{k} {ms:.1f} ms ({ms / busy:.3f})"
                      for k, ms in shares.items()))
    check(busy > 0 and shares["flash backward"] > 0
          and shares["flash forward"] > 0, "the profiler saw no flash "
          "kernels in the training step")
    del params, state, model
    torch.cuda.empty_cache()
    return launches, losses


def grad_slices(grads, ref=None, path=""):
    """(name, gradient, plain gradient or None) of every leaf of a
    gradient tree, a unit leaf (stacked over the units) split into each
    unit's slice."""
    for key, g in grads.items():
        name, r = f"{path}{key}", None if ref is None else ref[key]
        if isinstance(g, dict):
            yield from grad_slices(g, r, name + "/")
        elif name.startswith("units/"):
            for i in range(g.shape[0]):
                yield f"{name}[{i}]", g[i], None if r is None else r[i]
        else:
            yield name, g, r


def bf16_witness(torch, fa, model, params, batch, loss, grads,
                 what="full width and depth, the main path's first batch "
                 "and weights") -> None:
    """The kernels' bf16 loss and gradients (for the main path: at full
    width and depth, its first batch and weights) against autograd
    through the plain attention on the same weights and batch: the loss
    within ``BF16_LOSS_RTOL``, each leaf (each unit's slice of a unit
    leaf) within ``BF16_GRAD_RTOL`` of its largest plain value; the plain
    pass launches no flash kernel."""
    from repro_torch.launch.steps import value_and_grad

    t0 = time.perf_counter()
    before = dict(fa.launches)
    with plain_attention(fa):
        ref_loss, ref = value_and_grad(model.loss, params, batch)
    torch.cuda.synchronize()
    launched = sum(fa.launches[k] - before[k] for k in before)
    rel = {n: ((g.float() - r.float()).abs().max()
               / r.float().abs().max()).item()
           for n, g, r in grad_slices(grads, ref)}
    worst = max(rel, key=rel.get)
    dl = abs(loss.item() - ref_loss.item())
    print(f"  bf16 witness, B={batch['tokens'].shape[0]} "
          f"S={batch['tokens'].shape[1]}, {what}: loss kernels "
          f"{loss.item():.6f} vs plain attention "
          f"{ref_loss.item():.6f} (|diff| {dl:.2e}, tolerance "
          f"{BF16_LOSS_RTOL:g} x loss); {len(rel)} gradient slices, max "
          f"|kernels - plain| over the slice's largest plain value: worst "
          f"{rel[worst]:.3e} ({worst}), median "
          f"{statistics.median(rel.values()):.3e} (tolerance "
          f"{BF16_GRAD_RTOL:g}); flash launches in the plain pass: "
          f"{launched}; {time.perf_counter() - t0:.1f} s")
    check(launched == 0, "the plain pass launched flash kernels")
    check(dl <= BF16_LOSS_RTOL * abs(ref_loss.item()),
          "bf16 loss: kernels vs plain attention")
    check(rel[worst] <= BF16_GRAD_RTOL, f"bf16 gradient of {worst}: "
          f"{rel[worst]:.3e} of its largest plain value")


def plain_curve(torch, fa, losses) -> None:
    """The main path's ``TRAIN_STEPS`` steps again (same seed-0 weights,
    ``PackedLoader`` batches, AdamW and remat) with the attention through
    the plain version: its loss curve beside the kernels' ``losses``.  Its
    first loss is within ``BF16_LOSS_RTOL`` of the kernels' (same weights
    and batch); the curves are printed side by side, so that a rise in
    the kernels' curve the plain one shares is the optimizer's, not the
    kernels'."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_accum_train_step

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    model, opt, _ = make_train_step(cfg, lr=TRAIN_LR)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    state = (opt.init(params), None)
    step_fn = make_accum_train_step(model, opt)
    batches = _train_batches(torch, cfg, *TRAIN_SHAPE)
    before = dict(fa.launches)
    plain = []
    with plain_attention(fa):
        for _ in range(TRAIN_STEPS):
            params, state, loss = step_fn(params, state, next(batches))
            plain.append(loss.item())
    launched = sum(fa.launches[k] - before[k] for k in before)
    diffs = [abs(a - b) for a, b in zip(losses, plain)]
    peak = torch.cuda.max_memory_allocated()
    print(f"  the same {TRAIN_STEPS} steps with plain attention (autograd "
          f"through flash_attention_ref): loss "
          + " ".join(f"{x:.3f}" for x in plain) + " (kernels "
          + " ".join(f"{x:.3f}" for x in losses) + "); |kernels - plain| "
          "per step " + " ".join(f"{d:.3f}" for d in diffs)
          + f"; flash launches {launched}; peak allocated "
          f"{peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
    check(all(torch.isfinite(torch.tensor(plain))), "non-finite plain loss")
    check(launched == 0, "the plain steps launched flash kernels")
    check(diffs[0] <= BF16_LOSS_RTOL * abs(plain[0]),
          "first loss: kernels vs plain attention")
    del params, state, model
    torch.cuda.empty_cache()


def restart_drill(torch) -> None:
    """``TrainSupervisor.run_with_recovery`` in f32 at full width, depth
    cut to ``DRILL_LAYERS``, B=2, S=256, 6 steps, a checkpoint every 3
    (npz under build/), a failure injected at step 4: it restarts once
    from step 3 and its final params equal the clean run's within rtol
    1e-6 (the reference test's)."""
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import tree_leaves
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.fault_tolerance import TrainSupervisor

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              num_layers=DRILL_LAYERS)
    model, opt, step = make_train_step(cfg, lr=TRAIN_LR)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    data = _train_batches(torch, cfg, 2, 256, 6)
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)

    def run(fail, sub):
        sup = TrainSupervisor(step, CheckpointManager(
            os.path.join(root, sub), keep=2), ckpt_every=3)
        return sup.run_with_recovery(
            params, opt.init(params), lambda start: iter(data[start:]),
            n_steps=6, fail_at_step=fail)

    clean, failed = run(None, "clean"), run(4, "failed")
    shutil.rmtree(root, ignore_errors=True)
    pairs = list(zip(tree_leaves(failed["params"]),
                     tree_leaves(clean["params"])))
    within = all(bool(((a - b).abs() <= 1e-6 * b.abs()).all())
                 for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    print(f"  restart drill, f32 {TRAIN_ARCH} full width, depth CUT to "
          f"{DRILL_LAYERS} of 22 (npz checkpoints of params and AdamW "
          f"state stay quick), B=2 S=256, 6 steps, checkpoints every 3, "
          f"failure at step 4: restarts {failed['restarts']} (clean "
          f"{clean['restarts']}), final step {failed['final_step']}, final "
          f"params within rtol 1e-6 of the clean run's: {within}, bitwise: "
          f"{bitwise}; losses clean "
          + " ".join(f"{x:.4f}" for x in clean["losses"]) + ", after the "
          "restart " + " ".join(f"{x:.4f}" for x in failed["losses"])
          + f"; {time.perf_counter() - t0:.1f} s")
    check(failed["restarts"] == 1 and clean["restarts"] == 0
          and failed["final_step"] == 6, "restart drill: restarts / steps")
    check(within, "restart drill: final params differ from the clean run's")


def bwd_time(torch, fa, flush, q, k, v, o, lse, do) -> tuple:
    """The backward kernel's and one SDPA backward's median ms at one
    bf16 causal shape (L2 flushed), and the kernel's bound: (ms, library
    ms, bound ms, bound by, the bound's two times).  SDPA gets K/V
    expanded to H heads beforehand."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    G = H // KV
    ms = median_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                   flush, reps=10)
    qs = q.transpose(1, 2).contiguous().requires_grad_(True)
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() \
        .requires_grad_(True)
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() \
        .requires_grad_(True)
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                           is_causal=True)
    dos = do.transpose(1, 2).contiguous()
    lib_ms = median_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True), flush, reps=10)
    # the five products: q.k and dS.K, dS^T.Q over Dk; dout.v and P^T.dout
    # over Dv, each over the causal pairs; bytes: q, k, v, o, dout, lse
    # read, dq, dk, dv written
    pairs = S * (S + 1) // 2
    ops = 2 * B * H * pairs * (3 * Dk + 2 * Dv)
    nbytes = (2 * B * S * (2 * H * Dk + 2 * KV * Dk + 2 * KV * Dv
                           + 2 * H * Dv) + 4 * B * H * S)
    t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return ms, lib_ms, max(t_ops, t_bytes), by, t_ops, t_bytes


def train_wide(torch, fa, card) -> None:
    """Each model of ``WIDE_TRAIN`` in bf16 at full width, depth cut to
    ``WIDE_LAYERS``, remat and AdamW as configured, ``PackedLoader`` seed
    0 at ``WIDE_SHAPE``: a gradient pass through the kernels (one backward
    launch per layer; every leaf, each unit's slice of a unit leaf,
    finite and non-zero), the bf16 witness against autograd through the
    plain attention, ``WIDE_STEPS`` AdamW steps through
    ``make_accum_train_step`` (one backward launch per layer a step,
    finite losses); then the backward kernel at the model's attention
    shape against the plain backward in f32 and timed beside one SDPA
    backward."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.launch.train import make_accum_train_step

    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    B, S = WIDE_SHAPE
    for arch in WIDE_TRAIN:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_config(arch), num_layers=WIDE_LAYERS)
        check(cfg.dtype == "bfloat16", f"{arch} trains in bf16")
        Dk, Dv = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
                  if cfg.kv_lora_rank else (cfg.resolved_head_dim,) * 2)
        model, opt, _ = make_train_step(cfg, lr=TRAIN_LR)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        batches = _train_batches(torch, cfg, B, S)
        first = next(batches)
        before = fa.launches["flash_attention_bwd"]
        loss, grads = value_and_grad(model.loss, params, first)
        torch.cuda.synchronize()
        launched = fa.launches["flash_attention_bwd"] - before
        zero = [n for n, g, _ in grad_slices(grads)
                if not (bool(torch.isfinite(g).all())
                        and bool(g.abs().sum() > 0))]
        n_slices = sum(1 for _ in grad_slices(grads))
        print(f"  {arch} bf16 full width (Dk {Dk}, Dv {Dv}, H "
              f"{cfg.num_heads}, KV {cfg.num_kv_heads}), depth CUT to "
              f"{WIDE_LAYERS} of {get_config(arch).num_layers}, remat "
              f"{cfg.remat}, B={B} S={S}: loss {loss.item():.6f}; "
              f"{n_slices} gradient slices, finite and non-zero: "
              f"{n_slices - len(zero)}; flash backward launches in the "
              f"gradient pass {launched}")
        check(launched == WIDE_LAYERS, f"{arch}: {launched} flash backward "
              f"launches in a gradient pass, want {WIDE_LAYERS}")
        check(not zero, f"{arch}: zero or non-finite gradients: {zero}")
        bf16_witness(torch, fa, model, params, first, loss, grads,
                     what=f"{arch}, the same weights and batch")
        del grads
        state = (opt.init(params), None)
        step_fn = make_accum_train_step(model, opt)
        losses, times = [], []
        before = fa.launches["flash_attention_bwd"]
        for i in range(WIDE_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, loss = step_fn(params, state,
                                          first if i == 0 else next(batches))
            losses.append(loss.item())
            times.append(time.perf_counter() - t1)
        launched = fa.launches["flash_attention_bwd"] - before
        peak = torch.cuda.max_memory_allocated()
        print(f"  {arch}: {WIDE_STEPS} AdamW steps, loss "
              + " ".join(f"{x:.4f}" for x in losses) + ", step ms "
              + " ".join(f"{t * 1e3:.1f}" for t in times)
              + f", flash backward launches {launched}, peak allocated "
              f"{peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s")
        check(all(map(math.isfinite, losses)), f"{arch}: non-finite loss")
        check(launched == WIDE_LAYERS * WIDE_STEPS, f"{arch}: {launched} "
              f"flash backward launches in {WIDE_STEPS} steps")
        del params, state, model, opt, step_fn
        torch.cuda.empty_cache()
        # the backward kernel at this model's attention shape
        H, KV = cfg.num_heads, (cfg.num_heads if cfg.kv_lora_rank
                                else cfg.num_kv_heads)
        q, k, v = flash_inputs(torch, B, S, H, KV, Dk, Dv, "bfloat16", 41)
        do = torch.randn((B, S, H, Dv), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(43)).to(torch.bfloat16)
        o, lse = fa._forward(q, k, v, True, Dk ** -0.5, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        ref, rss = bwd_refs(fa, q, k, v, o, lse, do)
        errs = [(a.float() - r.float()).abs().max().item()
                for a, r in zip(got, ref)]
        frac = max(fa.bwd_error(a, r, e) for a, r, e in zip(got, ref, rss))
        del got, ref, rss
        ms, lib_ms, bound, by, t_ops, t_bytes = bwd_time(
            torch, fa, flush, q, k, v, o, lse, do)
        print(f"  flash_attention_bwd at {arch}'s attention, B={B} S={S} "
              f"H={H} KV={KV} Dk={Dk} Dv={Dv} bf16 causal: dq/dk/dv "
              f"max|diff| " + " ".join(f"{e:.3e}" for e in errs)
              + f" ({frac:.3f} of the tolerance); kernel {ms:.4f} ms, bound "
              f"{bound:.5f} ms by {by} (operations {t_ops:.5f} ms, bytes "
              f"{t_bytes:.5f} ms), {bound / ms:.4f} of the bound, one SDPA "
              f"backward {lib_ms:.4f} ms ({card})")
        check(frac <= 1, f"flash backward at {arch}'s attention shape")
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()


def bwd_times(torch, fa, flush) -> tuple:
    """The forward with the lse store and the backward kernel at the
    training shape (bf16, causal): first held against their plain versions
    on the same inputs (the output within the reference's bf16 2.5e-2, lse
    within 1e-4 of a plain logsumexp, dq/dk/dv within ``fa.bwd_error``'s
    bound of the plain backward in f32, two backward calls bitwise equal).
    Then timed, L2 flushed: kernel, plain version and one SDPA backward
    (K/V expanded to H heads beforehand); the bound from the five
    products the gradient needs at 989 bf16 TFLOP/s against the bytes
    read and written once (``bwd_time``); the forward with and
    without the lse store, beside its plain version and SDPA.  Returns the
    backward's (ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err)
    and the forward's."""
    B, S, H, KV, D = TRAIN_SHAPE + (32, 4, 64)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = flash_inputs(torch, B, S, H, KV, D, D, "bfloat16", 31)
    do = flash_inputs(torch, B, S, H, KV, D, D, "bfloat16", 32)[0]
    o, lse = fa._forward(q, k, v, True, D ** -0.5, with_lse=True)
    f_err = (o.float() - fa.flash_attention_ref(q, k, v).float()).abs() \
        .max().item()
    lse_err = (lse - fa.flash_attention_lse_ref(q, k)).abs().max().item()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    ref, rss = bwd_refs(fa, q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs = [(a.float() - r.float()).abs().max().item()
            for a, r in zip(got, ref)]
    fracs = [fa.bwd_error(a, r, e) for a, r, e in zip(got, ref, rss)]
    print(f"  B={B} S={S} H={H} KV={KV} D={D} bf16 causal, the training "
          f"shape: forward with the lse store max|diff| {f_err:.3e} "
          f"(tolerance 2.5e-2), lse {lse_err:.3e} (tolerance 1e-4); "
          f"backward dq/dk/dv max|diff| "
          + " ".join(f"{e:.3e}" for e in errs)
          + " (" + " ".join(f"{f:.3f}" for f in fracs) + " of the "
          f"{bwd_tolerance(fa)}); two backward calls bitwise equal")
    check(f_err <= 2.5e-2, f"flash forward at the training shape: {f_err}")
    check(lse_err <= 1e-4, f"flash lse at the training shape: {lse_err}")
    for name, a, b, r, f in zip(("dq", "dk", "dv"), got, again, ref, fracs):
        check(tuple(a.shape) == tuple(r.shape) and a.dtype == q.dtype
              and bool(torch.isfinite(a).all()),
              f"{name} at the training shape")
        check(torch.equal(a, b), f"flash backward {name} not repeatable at "
              "the training shape")
        check(f <= 1, f"flash backward {name} at the training shape: "
              f"{(a.float() - r.float()).abs().max().item()}, {f:.3f} of the "
              "tolerance")
    del got, again, ref, rss
    ms, lib_ms, bound, by, t_ops, t_bytes = bwd_time(torch, fa, flush, q, k,
                                                     v, o, lse, do)
    plain_ms = median_ms(torch, lambda: fa.flash_attention_bwd_ref(
        q, k, v, o, lse, do), flush, reps=3)
    ops = t_ops * BF16_FLOPS / 1e3
    print(f"  flash_attention_bwd B={B} S={S} H={H} KV={KV} D={D} bf16 "
          f"causal: kernel {ms:.4f} ms, bound {bound:.5f} ms by {by} (5 "
          f"products x {ops / 5e9:.3f} GFLOP at 989 bf16 TFLOP/s = "
          f"{t_ops:.5f} ms; bytes / 3.35 TB/s = {t_bytes:.5f} ms; the "
          f"kernel's 7 products at 989 TFLOP/s would take "
          f"{7 * t_ops / 5:.4f} ms), {bound / ms:.4f} of "
          f"the bound, plain {plain_ms:.4f} ms, one SDPA backward "
          f"{lib_ms:.4f} ms")
    bwd = (ms, plain_ms, lib_ms, bound, by, max(errs))
    f_ms = median_ms(torch, lambda: fa._forward(q, k, v, True, D ** -0.5,
                                                with_lse=False), flush)
    f_lse = median_ms(torch, lambda: fa._forward(q, k, v, True, D ** -0.5,
                                                 with_lse=True), flush)
    f_plain = median_ms(torch, lambda: fa.flash_attention_ref(q, k, v),
                        flush, reps=3)
    G, pairs = H // KV, S * (S + 1) // 2
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              for t in (k, v))
    with torch.no_grad():
        f_lib = median_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True),
                          flush)
    f_ops = 2 * 2 * B * H * D * pairs
    f_bytes = 2 * B * S * (H + KV + KV + H) * D
    ft_ops = f_ops / BF16_FLOPS * 1e3
    ft_bytes = f_bytes / HBM_BYTES_PER_S * 1e3
    f_bound = max(ft_ops, ft_bytes)
    f_by = "bytes" if ft_bytes >= ft_ops else "operations"
    print(f"  flash_attention B={B} S={S} H={H} KV={KV} D={D} bf16 causal: "
          f"kernel {f_ms:.4f} ms, with the lse store {f_lse:.4f} ms, bound "
          f"{f_bound:.5f} ms by {f_by}, {f_bound / f_lse:.4f} of the bound "
          f"(with lse), plain {f_plain:.4f} ms, SDPA {f_lib:.4f} ms")
    return bwd, (f_lse, f_plain, f_lib, f_bound, f_by, f_err)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.torch_backend import ROWS

    # full f32 products in every f32 comparison (the kernels use f32 FMAs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t_start = t0 = time.perf_counter()
    libs = ["paged_attention", "flash_attention", "flash_attention_bwd"]
    default_chunk = pa.CHUNK
    build_all(build, libs, default_chunk)
    print(f"build: {time.perf_counter() - t0:.2f} s ("
          + ", ".join(build.library_path(n).name for n in libs) + ", and "
          "the paged kernels at chunk lengths "
          + ", ".join(str(c) for c in CHUNKS if c != default_chunk) + ")")
    ptxas_report(build.build_log("flash_attention"), fa)
    bwd_ptxas_report(build.build_log("flash_attention_bwd"), fa)
    paged_ptxas_report(build.build_log("paged_attention"), pa)

    # 3. kernels against their plain versions
    main_err = check_paged_all(torch, pa)

    # 4. end to end at full width
    print("serving tinyllama-1.1b (full width, bf16, random weights), gmg:")
    be, summ, counts_f, dig_f1 = serve(torch, pa, fused=True, decode_steps=1)
    fwd_f = be.n_decode_forwards
    streams1 = {r: list(t) for r, t in be.generated.items()}
    tok = torch.zeros((64, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros(64, dtype=torch.int32, device="cuda")
    tabs = torch.full((64, be.n_max), be.scrap, dtype=torch.int32,
                      device="cuda")
    logits, _ = be.model.decode_paged(be.params, be.pages, tok, pos, tabs,
                                      fused=True)
    check(tuple(logits.shape) == (64, be.cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "decode logits")
    invariant = batch_invariance(torch, be, ROWS)
    check(invariant["fixed"], "results depend on the batch grouping or the "
          "prefill chunking under the backend's fixed row counts")
    verify_vs_decode(torch, be, ROWS)
    decode_breakdown(torch, be)
    sampler_breakdown(torch)
    del be, logits
    torch.cuda.empty_cache()
    check(counts_f["fused_decode_attention"] > 0,
          "fused_decode_attention never launched on the main path")
    be, _, _, dig_f4 = serve(torch, pa, fused=True, decode_steps=4)
    del be
    torch.cuda.empty_cache()
    be, _, counts_u, dig_u1 = serve(torch, pa, fused=False, decode_steps=1)
    fwd_u = be.n_decode_forwards
    del be
    torch.cuda.empty_cache()
    check(counts_u["paged_attention"] > 0,
          "paged_attention never launched on the fused=False path")
    print(f"  digests: fused n=1 {dig_f1}, fused n=4 {dig_f4}, "
          f"unfused n=1 {dig_u1}")
    check(dig_f4 == dig_f1, "decode_steps=4 changed the token streams")
    check(dig_u1 == dig_f1, "fused=False changed the token streams")

    # 4b. speculative decoding: vllm grants every lane the depth ceiling;
    # streams must equal plain decoding's at temperature 0 and 0.8, with
    # n-gram drafts and with drafts replayed from the plain run
    print("speculative decoding, full width:")
    digests, spec, replayed = {}, None, {}
    for temperature in (0.0, 0.8):
        for depth, n in ((0, 1), (4, 1), (0, 4), (4, 4)):
            if temperature == 0.0 and (depth, n) == (0, 4):
                continue          # the gmg runs above cover n=4 without spec
            be, summ, counts, dig = serve(
                torch, pa, decode_steps=n, scheduler="vllm", spec=depth,
                temperature=temperature, prompts=motif_prompts)
            digests[temperature, depth, n] = dig
            if (depth, n) == (0, 1):
                replay = replay_of(be, motif_prompts)
            if (temperature, depth, n) == (0.0, 4, 1):
                spec = (counts, be.n_verify_forwards, summ)
            if depth:
                check(summ.spec_proposed > 0, "the drafter proposed nothing")
                check(counts["fused_verify_attention"] > 0,
                      "fused_verify_attention never launched on the "
                      "speculative path")
            del be
            torch.cuda.empty_cache()
        be, summ, counts, dig = serve(
            torch, pa, scheduler="vllm", spec=4, temperature=temperature,
            prompts=motif_prompts, drafter=replay)
        digests[temperature, "replayed", 1] = dig
        replayed[temperature] = summ
        check(summ.spec_accepted > 0, "no replayed draft was accepted")
        check(counts["fused_verify_attention"] > 0,
              "fused_verify_attention never launched on the replayed run")
        del be
        torch.cuda.empty_cache()
    be, summ_g, _, dig_g4 = serve(torch, pa, scheduler="gmg", spec=4)
    del be
    torch.cuda.empty_cache()
    counts_v, fwd_v, summ_v = spec
    print(f"  digests: vllm t=0 {digests[0.0, 0, 1]} (spec 0), "
          f"{digests[0.0, 4, 1]} (spec 4), {digests[0.0, 4, 4]} (spec 4, "
          f"n=4), {digests[0.0, 'replayed', 1]} (spec 4, replayed drafts); "
          f"gmg spec 4 {dig_g4} (spec 0 {dig_f1}); vllm t=0.8 "
          f"{digests[0.8, 0, 1]} (spec 0), {digests[0.8, 4, 1]} (spec 4), "
          f"{digests[0.8, 0, 4]} (spec 0, n=4), {digests[0.8, 4, 4]} (spec 4, "
          f"n=4), {digests[0.8, 'replayed', 1]} (spec 4, replayed drafts); "
          f"n-gram drafts accepted {summ_v.spec_accepted} of "
          f"{summ_v.spec_proposed} proposed (vllm t=0 spec 4), gmg "
          f"{summ_g.spec_accepted} of {summ_g.spec_proposed}; replayed "
          f"drafts accepted {replayed[0.0].spec_accepted} of "
          f"{replayed[0.0].spec_proposed} at t=0, "
          f"{replayed[0.8].spec_accepted} of {replayed[0.8].spec_proposed} "
          f"at t=0.8")
    for (temperature, depth, n), dig in digests.items():
        check(dig == digests[temperature, 0, 1],
              f"spec {depth}, decode_steps {n} changed the token streams at "
              f"temperature {temperature}")
    check(dig_g4 == dig_f1, "spec 4 changed the gmg token streams")

    # 4c. the fleet: disaggregated and routed replicas on the card
    fleet(torch, pa, dig_f1, card)

    # 4c'. serving tensor parallelism, the ranks sharing the card
    tp_err, tp_launches = tp_phase(torch, pa, card, streams1)
    main_err.update({k: max(main_err[k], v) for k, v in tp_err.items()})

    # 4c''. the roofline of a decode dispatch; expert parallelism over
    # ranks sharing the card
    roof_launches = roofline_phase(torch, pa, card)
    tp_launches["fused_decode_attention"] += roof_launches
    ep_phase(torch, card)

    # 4d. the MoE model through the paged path, full width, depth cut
    kimi_launches = kimi_serving(torch, pa, card)

    # 5. times at the main path's shapes: B=8 lanes at ctx 512, bf16
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    B, H, KV, D, page, ctx = 8, 32, 4, 64, 16, 512
    c = case(torch, B, H, KV, D, page, [ctx] * B, torch.bfloat16, seed=7)
    e = 2                                    # bytes per bf16 element
    kv_bytes = 2 * B * ctx * KV * D * e
    io_bytes = 2 * B * H * D * e + B * (ctx // page) * 4 + B * 4
    # q.k and p.v each 2 * B * ctx * H * D operations: the bf16 q.k
    # products are exact in f32 (the tensor cores' rate), p.v multiplies
    # f32 probabilities (the f32 rate)
    ops = 2 * B * ctx * H * D
    # library yardstick: one SDPA call over K/V gathered beforehand
    tab = c["tables"].long()
    kg = c["k_pages"][tab].reshape(B, ctx, KV, D).transpose(1, 2)
    vg = c["v_pages"][tab].reshape(B, ctx, KV, D).transpose(1, 2)
    kg = kg.repeat_interleave(H // KV, dim=1).contiguous()
    vg = vg.repeat_interleave(H // KV, dim=1).contiguous()
    qs = c["q"][:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = median_ms(torch, lambda: sdpa(qs, kg, vg), flush)
    pos = c["ctx"] - 1
    args_f = (c["q"], c["k_new"], c["v_new"], c["k_pages"], c["v_pages"],
              c["tables"], pos)
    args_a = (c["q"], c["k_pages"], c["v_pages"], c["tables"], c["ctx"])
    bytes_of = {"paged_attention": kv_bytes + io_bytes,
                "fused_decode_attention": kv_bytes + io_bytes
                + 4 * B * KV * D * e}
    timed = {
        "fused_decode_attention": (
            lambda: pa.fused_decode_attention(*args_f),
            lambda: pa.fused_decode_attention_ref(*args_f),
            counts_f["fused_decode_attention"], fwd_f),
        "paged_attention": (
            lambda: pa.paged_attention(*args_a),
            lambda: pa.paged_attention_ref(*args_a),
            counts_u["paged_attention"], fwd_u)}
    # the verify kernel at B=8, W=5, the last row at ctx 512
    W = 5
    cv = verify_case(torch, B, W, H, KV, D, page, [ctx - W + 1] * B, [W] * B,
                     torch.bfloat16, seed=8)
    args_v = (cv["q"], cv["k_new"], cv["v_new"], cv["k_pages"],
              cv["v_pages"], cv["tables"], cv["pos0"], cv["widths"])
    tab = cv["tables"].long()[:, :ctx // page]
    kg = cv["k_pages"][tab].reshape(B, ctx, KV, D).transpose(1, 2)
    vg = cv["v_pages"][tab].reshape(B, ctx, KV, D).transpose(1, 2)
    kg = kg.repeat_interleave(H // KV, dim=1).contiguous()
    vg = vg.repeat_interleave(H // KV, dim=1).contiguous()
    qv = cv["q"].transpose(1, 2).contiguous()          # (B, H, W, D)
    # row s sees keys up to pos0 + s: causal within the window
    mask = (torch.arange(ctx, device="cuda")[None, :]
            <= torch.arange(ctx - W, ctx, device="cuda")[:, None])
    lib_v_ms = median_ms(torch, lambda: sdpa(qv, kg, vg, attn_mask=mask),
                         flush)
    bytes_of["fused_verify_attention"] = (
        kv_bytes + 2 * B * W * H * D * e + 4 * B * W * KV * D * e
        + B * cv["tables"].shape[1] * 4 + 2 * B * 4)
    timed["fused_verify_attention"] = (
        lambda: pa.fused_verify_attention(*args_v),
        lambda: pa.fused_verify_attention_ref(*args_v),
        counts_v["fused_verify_attention"], fwd_v)
    ops_of = {"paged_attention": ops, "fused_decode_attention": ops,
              # row s attends ctx - W + 1 + s tokens
              "fused_verify_attention": sum(2 * B * (ctx - W + 1 + s) * H * D
                                            for s in range(W))}
    lib_of = {"paged_attention": lib_ms, "fused_decode_attention": lib_ms,
              "fused_verify_attention": lib_v_ms}
    records = []
    print(f"times (B={B}, H={H}, KV={KV}, D={D}, page={page}, ctx={ctx}, "
          f"bf16, L2 flushed; median of CUDA events; the verify kernel with "
          f"W={W} rows per lane, the last at ctx {ctx}):")
    for name, (kern, plain, launches, forwards) in timed.items():
        ms = median_ms(torch, kern, flush)
        plain_ms = median_ms(torch, plain, flush)
        t_bytes = bytes_of[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops_of[name] * (1 / BF16_FLOPS + 1 / F32_FLOPS) * 1e3
        bound_ms = max(t_bytes, t_ops)
        per_step = launches / forwards
        print(f"  {name}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"(bytes {bytes_of[name]} B / 3.35 TB/s = {t_bytes:.5f} ms; "
              f"operations 2 x {ops_of[name]} at 989 bf16 + 67 f32 TFLOP/s "
              f"= {t_ops:.5f} ms), plain {plain_ms:.4f} ms, "
              f"SDPA {lib_of[name]:.4f} ms, {launches} launches = "
              f"{per_step:g} per {'verify' if 'verify' in name else 'decode'}"
              f" forward on tinyllama-1.1b, {kimi_launches[name]} on "
              f"kimi-k2's, {tp_launches[name]} on the tensor-parallel runs' "
              f"ranks and the roofline phase")
        records.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches + kimi_launches[name] + tp_launches[name],
            max_abs_err=main_err[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_of[name]))

    # 5b. the paged kernels at every chunk length
    chunk_sweep(torch, pa, build, flush, default_chunk)

    # 6. the full-sequence forward: the flash kernel against its plain
    # version, then each model in f32 and on its bf16 main path
    print("flash_attention vs its plain version:")
    flash_err, family_err = check_flash(torch, fa)
    check_flash_mask(torch, fa)
    print("full-sequence forward, full width (random weights from seed 0):")
    flash_launches = {arch: fullseq(torch, fa, arch) for arch in FULLSEQ}
    # 6b. the recurrent and frontend families: f32 checks, mixers on the
    # card against the CPU, a bf16 gradient pass, the bf16 main path
    print("recurrent and frontend families, full width (random weights "
          "from seed 0):")
    t_fam = time.perf_counter()
    family_runs = {arch: family(torch, fa, arch, card) for arch in RECURRENT}
    family_launches = {a: n for a, (n, _) in family_runs.items()}
    print(f"  families: {time.perf_counter() - t_fam:.1f} s, peak allocated "
          f"{max(p for _, p in family_runs.values()) / 2**30:.2f} GiB; main "
          f"path flash launches {family_launches}")
    print("flash_attention times (bf16, causal, L2 flushed; median of CUDA "
          "events):")
    ft = flash_times(torch, fa, flush)
    # one record at tinyllama's prefill shape (launches of every model's
    # main path), one at deepseek-v2-lite's head dims (its launches)
    for name, arch, launches in (
            ("flash_attention", "tinyllama-1.1b",
             sum(flash_launches.values())),
            ("flash_attention (Dk 192, Dv 128)", "deepseek-v2-lite-16b",
             flash_launches["deepseek-v2-lite-16b"])):
        ms, plain_ms, lib_ms, bound_ms, by = ft[arch]
        records.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE,
            replaces=FLASH_REPLACES, launches=launches,
            max_abs_err=(flash_err[192, 128] if "192" in name
                         else max(flash_err.values())),
            ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms))
    # one record per family with attention, at its main path's shape (its
    # launches, its error there)
    for arch, name in (
            ("musicgen-medium", "musicgen-medium: H 24 MHA, D 64"),
            ("pixtral-12b", "pixtral-12b: G 4, D 128, S 2048"),
            ("jamba-v0.1-52b", "jamba-v0.1-52b: G 4, D 128, S 1024")):
        ms, plain_ms, lib_ms, bound_ms, by = ft[arch]
        records.append(dict(
            name=f"flash_attention ({name})", route="cuda",
            source=FLASH_SOURCE, replaces=FLASH_REPLACES,
            launches=family_launches[arch], max_abs_err=family_err[arch],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))

    # 7. training: the backward kernel against its plain version, the f32
    # step on the card against the CPU's, the main path at full width (its
    # launches counted from 0 just before it), the restart drill, bf16
    # steps at the other full-width head dims, times
    t_train = time.perf_counter()
    print("flash_attention backward vs its plain version:")
    check_bwd_all(torch, fa)
    print("training, full width (random weights from seed 0):")
    train_vs_cpu(torch, fa)
    train_launches, train_losses = train_main(torch, fa, card)
    plain_curve(torch, fa, train_losses)
    restart_drill(torch)
    train_wide(torch, fa, card)
    print("flash_attention backward and forward at the training shape "
          "(L2 flushed; median of CUDA events):")
    bwd, fwd = bwd_times(torch, fa, flush)
    # max_abs_err: at the training shape, the main path's
    for name, source, replaces, key, (ms, plain_ms, lib_ms, bound_ms, by,
                                      err) in (
            ("flash_attention_bwd", BWD_SOURCE, BWD_REPLACES,
             "flash_attention_bwd", bwd),
            ("flash_attention (B 8, S 2048, with lse)", FLASH_SOURCE,
             FLASH_REPLACES, "flash_attention", fwd)):
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=train_launches[key], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))
    print(f"  training phase: {time.perf_counter() - t_train:.1f} s")
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    # 8. kernel records, then 9. the device
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
