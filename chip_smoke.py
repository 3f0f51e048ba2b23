#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout: builds the CUDA kernels from
``src/repro_torch/csrc``, holds each against its plain PyTorch version,
serves full-width tinyllama-1.1b (random bf16 weights from a seed) through
``ServeEngine`` under the gmg scheduler (fused and unfused attention,
one and four decode steps per call, equal token streams required),
probes whether results depend on batch grouping or prefill chunking,
profiles one decode forward, and times the kernels with CUDA events.
Prints the card, the checks, one JSON line of kernel records and,
last, one JSON line naming the device.  Exits non-zero, with no result
lines, on any failed check, when CUDA is unavailable, or outside a checkout.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
SOURCE = "src/repro_torch/csrc/paged_attention.cu"
REPLACES = {"fused_decode_attention": "src/repro/kernels/paged_attention.py:147",
            "paged_attention": "src/repro/kernels/paged_attention.py:462"}
# the capped mixed workload of the quickstart's real-execution mode
WORKLOAD = dict(rate=1.5, duration=6.0, seed=0, mix=(2, 1, 1), prompt_cap=40,
                output_cap=12, slo_scale=20.0)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def stream_digest(backend) -> str:
    """Order-independent digest of every request's generated tokens."""
    streams = sorted((rid, tuple(t)) for rid, t in backend.generated.items())
    return hashlib.sha256(repr(streams).encode()).hexdigest()[:16]


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


def serving_case(torch, B, ctxs, seed):
    """The decode call the serving path makes at full width: B lanes, the
    first len(ctxs) live at those contexts on a padded table (pages past
    the context name the scrap page), the rest padding lanes at position 0
    on the all-scrap table.  n_max 16 (max_len 256), bf16."""
    H, KV, D, page, n_max = 32, 4, 64, 16, 16
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
    """Both kernels against their plain versions on one case; returns each
    kernel's largest output difference.  The fused kernel's outputs are
    compared on the first ``live`` lanes only (default all): padding lanes
    all write and read the scrap page's slot 0 at once, so theirs are
    whatever row won.  In bf16 both sides compute in f32 and round once, so
    besides ``atol`` every element must lie within one bf16 ulp of the
    plain version's (|diff| <= 2^-7 |plain| + 1e-5): at context 512 one
    dropped token moves an output by about 2e-3, past that limit, where
    ``atol`` alone would not notice it."""
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
    torch.cuda.synchronize()
    pools_equal = bool(torch.equal(kk[:-1], kr[:-1])
                       and torch.equal(vk[:-1], vr[:-1]))
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
          f"page: {pools_equal}")
    check(pools_equal, f"fused_decode_attention {label}: pools differ")
    return errs


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


def serve(torch, pa, fused, decode_steps):
    """Full-width tinyllama-1.1b through run(); kernel launch counts are
    zeroed just before the run and read just after it."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.run import (BackendSpec, ExperimentSpec,
                                         TelemetrySpec, run)
    from repro_torch.serving.torch_backend import PagedTorchBackend
    from repro_torch.serving.workload import WorkloadSpec

    be = PagedTorchBackend(arch="tinyllama-1.1b", reduced=False,
                           num_blocks=512, page=16, max_len=256, seed=0,
                           fused=fused)
    check(be.cfg.d_model == 2048 and be.cfg.num_layers == 22
          and be.cfg.dtype == "bfloat16", "full-width tinyllama config")
    obs = MetricsRegistry()
    for k in pa.launches:
        pa.launches[k] = 0
    t0 = time.perf_counter()
    summ = run(ExperimentSpec(
        scheduler="gmg", workload=WorkloadSpec(**WORKLOAD),
        engine=EngineConfig(max_batch=8, prefill_budget=32,
                            decode_steps=decode_steps),
        backend=BackendSpec(kind=be), telemetry=TelemetrySpec(obs=obs)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(pa.launches)
    digest = stream_digest(be)
    tokens = [t for toks in be.generated.values() for t in toks]
    print(f"  fused={fused} decode_steps={decode_steps}: finished "
          f"{summ.n_finished}, goodput {summ.goodput_frac:.3f}, "
          f"{summ.throughput_tok_s:.1f} tok/s (engine clock), "
          f"{len(tokens)} tokens in {wall:.2f} s wall, launches {counts}, "
          f"decode forwards {be.n_decode_forwards}, digest {digest}")
    print(f"    engine makespan {summ.makespan:.3f} s; backend device "
          f"{obs.value_of('torch_device_seconds_total'):.3f} s, host "
          f"{obs.value_of('torch_host_seconds_total'):.3f} s; "
          f"{be.n_decode_dispatches} decode calls, "
          f"{be.n_prefill_dispatches} prefill chunks")
    check(summ.n_finished > 0, "no request finished")
    check(summ.goodput_frac > 0, "zero goodput")
    check(all(0 <= t < be.cfg.vocab_size for t in tokens), "token range")
    return be, summ, counts, digest


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def batch_invariance(torch, be, rows) -> dict:
    """Whether full-width results are bitwise independent of how the
    engine groups and chunks work, under two padding policies: the
    backend's (``rows`` lanes per decode call, ``rows``-token prefill
    calls) and the reference's power-of-two widths.  Eight lanes at
    contexts 5-52 are decoded in groups of 1, 2, 4 and 8 lanes per call,
    each group padded to the policy's width, and each lane's logits held
    against the groups-of-8 run; one 52-token prompt is prefilled in three
    chunkings and its KV compared.  Prints both; returns {policy: all
    bitwise equal}."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ctxs = [5, 16, 17, 33, 40, 48, 49, 52]
    per = -(-max(ctxs) // be.page)            # pages per lane
    dev = "cuda"
    policies = {"fixed": (lambda n: rows, lambda n: rows),
                "power-of-two": (lambda n: _pow2(n, 1),
                                 lambda n: _pow2(n, 8))}

    def ints(*shape):
        return torch.randint(0, be.cfg.vocab_size, shape, generator=g,
                             device=dev, dtype=torch.int32)

    def table(first):
        t = torch.full((be.n_max,), be.scrap, dtype=torch.int32, device=dev)
        t[:per] = torch.arange(first, first + per, dtype=torch.int32,
                               device=dev)
        return t

    def prefill(tab, prompt, chunks, width):
        start = 0
        for n in chunks:
            toks = torch.zeros((1, width(n)), dtype=torch.int32, device=dev)
            toks[0, :n] = prompt[start:start + n]
            be.pages = be.model.prefill_paged(be.params, be.pages, toks,
                                              start, tab, n)
            start += n

    def kv_of(tab, n):
        return torch.cat([
            (p[:, tab.long()].flatten(1, 2)[:, :n] if p.dim() == 5
             else p[tab.long()].flatten(0, 1)[:n]).reshape(-1)
            for pool in [*be.pages["prefix"], *be.pages["units"].values()]
            for p in pool.values()]).float()

    # the decode lanes: each prefilled to ctx-1 tokens on its own pages
    tabs = torch.stack([table(i * per) for i in range(8)])
    for i, c in enumerate(ctxs):
        prefill(tabs[i], ints(c - 1), [c - 1], policies["fixed"][1])
    tok = ints(8, 1)
    pos = torch.tensor(ctxs, dtype=torch.int32, device=dev) - 1
    prompt = ints(52)

    def decode(group, width):
        """The 8 lanes' logits from calls of ``group`` live lanes each,
        padded to ``width(group)`` lanes on the all-scrap table."""
        outs = []
        W = width(group)
        for lo in range(0, 8, group):
            t = torch.zeros((W, 1), dtype=torch.int32, device=dev)
            p = torch.zeros(W, dtype=torch.int32, device=dev)
            tb = torch.full((W, be.n_max), be.scrap, dtype=torch.int32,
                            device=dev)
            t[:group], p[:group] = tok[lo:lo + group], pos[lo:lo + group]
            tb[:group] = tabs[lo:lo + group]
            logits, be.pages = be.model.decode_paged(
                be.params, be.pages, t, p, tb, fused=be.fused)
            outs.append(logits[:group])
        return torch.cat(outs)

    result = {}
    for k, (name, (dec_w, pf_w)) in enumerate(policies.items()):
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
        print(f"  batch invariance, {name} padding: decode in groups of "
              f"[{'; '.join(parts)}] vs groups of 8; prefill KV of 52 "
              f"tokens in chunks 32+20 and 16x3+4 vs 52: max|diff| "
              f"{pf_diff:.3e}; {'all equal' if equal else 'NOT all equal'}")
        result[name] = equal
    return result


def decode_breakdown(torch, be) -> None:
    """Where one full-width decode forward's time goes: the serving path's
    call shape (64 lanes, 8 of them live at context 48), timed on the
    host clock and with the profiler's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    B, live, ctx = 64, 8, 48
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    pos[:live] = ctx - 1
    tabs = torch.full((B, be.n_max), be.scrap, dtype=torch.int32,
                      device="cuda")
    tabs[:live, :ctx // be.page] = torch.arange(
        live * (ctx // be.page), dtype=torch.int32,
        device="cuda").reshape(live, -1)

    def fwd():
        return be.model.decode_paged(be.params, be.pages, tok, pos, tabs,
                                     fused=True)

    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages() if dev_us(e) > 0
               and not e.key.startswith(("aten::", "cuda", "Memcpy",
                                         "Memset"))]
    busy_ms = sum(dev_us(e) for e in kernels) / reps / 1e3
    print(f"  decode forward, {B} lanes ({live} live at ctx {ctx}): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{sum(e.count for e in kernels) / reps:.0f} kernels")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"    {dev_us(e) / reps / 1e3:.4f} ms x{e.count // reps} "
              f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
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
    t0 = time.perf_counter()
    build.build(["paged_attention"])
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path('paged_attention').name})")

    # 3. kernels against their plain versions
    print("kernels vs plain versions:")
    main_err = dict.fromkeys(pa.launches, 0.0)   # at the main path's shapes
    main_ctxs = {1: [512], 8: [1, 15, 16, 17, 100, 256, 511, 512]}
    for B, ctxs in main_ctxs.items():
        c = case(torch, B, 32, 4, 64, 16, ctxs, torch.bfloat16, seed=B)
        errs = check_kernels(torch, pa, c, 2e-2,
                             f"bf16 B={B} H=32 KV=4 D=64 ctx<={max(ctxs)}")
        main_err = {k: max(v, errs[k]) for k, v in main_err.items()}
    # the serving path's own call shapes: 8 live lanes at contexts across
    # page edges, beside padding lanes on the all-scrap table (a batch of
    # 5 pads to 8 lanes; 64 lanes is the widest padding checked)
    live_ctxs = [1, 15, 16, 17, 32, 33, 48, 52]
    for B, live in ((8, 5), (8, 8), (64, 8)):
        c = serving_case(torch, B, live_ctxs[:live], seed=200 + B + live)
        errs = check_kernels(torch, pa, c, 2e-2,
                             f"bf16 B={B} ({live} live, ctx<=52) H=32 KV=4 "
                             f"D=64 n_max=16", live=live)
        main_err = {k: max(v, errs[k]) for k, v in main_err.items()}
    sweep = [(3, 6, 3, 64, 16, [1, 40, 200]),       # GQA, heads not 2^k
             (2, 8, 1, 128, 16, [77, 300]),         # MQA, D=128
             (2, 16, 4, 16, 8, [5, 64]),            # D=16, page 8
             (2, 8, 2, 128, 16, [128, 129])]        # D=128, page edge
    for i, (B, H, KV, D, page, ctxs) in enumerate(sweep):
        c = case(torch, B, H, KV, D, page, ctxs, torch.float32, seed=100 + i)
        check_kernels(torch, pa, c, 1e-5,
                      f"f32 B={B} H={H} KV={KV} D={D} page={page}")

    # 4. end to end at full width
    print("serving tinyllama-1.1b (full width, bf16, random weights), gmg:")
    be, summ, counts_f, dig_f1 = serve(torch, pa, fused=True, decode_steps=1)
    fwd_f = be.n_decode_forwards
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
    decode_breakdown(torch, be)
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

    # 5. times at the main path's shapes: B=8 lanes at ctx 512, bf16
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    B, H, KV, D, page, ctx = 8, 32, 4, 64, 16, 512
    c = case(torch, B, H, KV, D, page, [ctx] * B, torch.bfloat16, seed=7)
    e = 2                                    # bytes per bf16 element
    kv_bytes = 2 * B * ctx * KV * D * e
    io_bytes = 2 * B * H * D * e + B * (ctx // page) * 4 + B * 4
    ops = 4 * B * ctx * H * D                # q.k and p.v, f32 FMAs
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
    records = []
    print(f"times (B={B}, H={H}, KV={KV}, D={D}, page={page}, ctx={ctx}, "
          f"bf16, L2 flushed; median of CUDA events):")
    for name, (kern, plain, launches, forwards) in timed.items():
        ms = median_ms(torch, kern, flush)
        plain_ms = median_ms(torch, plain, flush)
        t_bytes = bytes_of[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        per_step = launches / forwards
        print(f"  {name}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bytes_of[name]} B / 3.35 TB/s), plain {plain_ms:.4f} ms, "
              f"SDPA {lib_ms:.4f} ms, {launches} launches = {per_step:g} per "
              f"decode micro-step")
        records.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches, max_abs_err=main_err[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms))

    # 6. kernel records, then 7. the device
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
