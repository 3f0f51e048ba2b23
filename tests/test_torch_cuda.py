"""The port's CUDA kernels on the card: each against its plain PyTorch
version (the verify kernel also bitwise against chained decode-kernel
launches, the attend-only kernel bitwise the fused one, a lane alone
bitwise among 64, contexts across the paged kernels' chunk edges), the
reduced model's token streams equal across attention modes, decode
horizons and speculation, the flash kernel's causal mask, the flash
backward kernel against its plain version (bitwise repeatable), the reduced
full-sequence forward and the reduced ``Model.loss`` gradients on the card
equal to the CPU's (MoE stacks among them), a 2-replica reduced fleet (disaggregated and routed) with merged
streams equal to one replica's, the migration round trip bitwise,
tensor-parallel ranks sharing the card streaming as one rank, the
roofline counter's decode dispatch and flash launches on the card (not
opaque), expert-parallel ranks sharing the card equal to
``moe_ep_ref``, the decode forward's CUDA graphs: replays bitwise the
eager forward, streams equal with graphs and without, graphs dropped and
captured again for new weights, a replay allocating only its logits, and
the profiler placing a replay's kernels under its ``cudaGraphLaunch``,
a ticket buffer a graph may read kept after a wider launch;
and the prefill forward's: replays writing the eager forward's pages
across chunkings, streams equal with graphs and without, a replay
allocating nothing.
Marked ``cuda``; skips without a GPU.  Run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol,B,H,KV,D,page,ctxs", [
    (torch.bfloat16, 2e-2, 4, 32, 4, 64, 16, [1, 16, 17, 300]),
    (torch.float32, 1e-5, 3, 6, 3, 64, 16, [1, 40, 200]),
    (torch.float32, 1e-5, 2, 8, 1, 128, 8, [9, 64]),
])
def test_kernels_match_plain_versions(cuda, dtype, atol, B, H, KV, D, page,
                                      ctxs):
    from repro_torch.kernels import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(0)
    n_max = max(-(-c // page) for c in ctxs)
    P = B * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, kn, vn = rnd(B, H, D), rnd(B, KV, D), rnd(B, KV, D)
    kp, vp = rnd(P, page, KV, D), rnd(P, page, KV, D)
    tab = torch.randperm(P - 1, generator=g, device=cuda)
    tab = tab.reshape(B, n_max).to(torch.int32)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=cuda)
    before = dict(pa.launches)
    out = pa.paged_attention(q, kp, vp, tab, ctx)
    ref = pa.paged_attention_ref(q, kp, vp, tab, ctx)
    assert (out.float() - ref.float()).abs().max().item() <= atol
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o1, k1, v1 = pa.fused_decode_attention(q, kn, vn, k1, v1, tab, ctx - 1)
    o2, k2, v2 = pa.fused_decode_attention_ref(q, kn, vn, k2, v2, tab,
                                               ctx - 1)
    torch.cuda.synchronize()
    assert (o1.float() - o2.float()).abs().max().item() <= atol
    assert torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])
    assert pa.launches["paged_attention"] == before["paged_attention"] + 1
    assert pa.launches["fused_decode_attention"] == \
        before["fused_decode_attention"] + 1


def test_kernels_match_plain_versions_beside_padding_lanes(cuda):
    """The serving path's decode call: 64 lanes, 8 live at contexts across
    page edges, 56 padding lanes at position 0 on the all-scrap table, all
    writing the scrap page's slot 0 at once.  Live lanes' outputs (every
    lane's for the read-only kernel) and pools off the scrap page match."""
    from repro_torch.kernels import paged_attention as pa
    B, H, KV, D, page, n_max = 64, 32, 4, 64, 16, 16
    ctxs = [1, 15, 16, 17, 32, 33, 48, 52]
    live = len(ctxs)
    g = torch.Generator(device=cuda).manual_seed(1)
    P = live * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    q, kn, vn = rnd(B, H, D), rnd(B, KV, D), rnd(B, KV, D)
    kp, vp = rnd(P, page, KV, D), rnd(P, page, KV, D)
    pages = torch.randperm(P - 1, generator=g, device=cuda).to(torch.int32)
    tab = torch.full((B, n_max), P - 1, dtype=torch.int32, device=cuda)
    ctx = torch.ones(B, dtype=torch.int32, device=cuda)
    for i, c in enumerate(ctxs):
        used = -(-c // page)
        tab[i, :used] = pages[i * n_max:i * n_max + used]
        ctx[i] = c
    out = pa.paged_attention(q, kp, vp, tab, ctx)
    ref = pa.paged_attention_ref(q, kp, vp, tab, ctx)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o1, k1, v1 = pa.fused_decode_attention(q, kn, vn, k1, v1, tab, ctx - 1)
    o2, k2, v2 = pa.fused_decode_attention_ref(q, kn, vn, k2, v2, tab,
                                               ctx - 1)
    torch.cuda.synchronize()
    assert (o1[:live].float() - o2[:live].float()).abs().max().item() <= 2e-2
    assert torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])


def _chunk_ctxs(C, cap):
    """Contexts around the kernels' chunk edges, up to a capacity."""
    return sorted({min(x, cap) for x in (1, C - 1, C, C + 1, 2 * C - 1,
                                         2 * C + 1, 3 * C, cap - 1, cap)})


@pytest.mark.parametrize("dtype,atol,H,KV,D", [
    (torch.bfloat16, 2e-2, 32, 4, 64),       # tinyllama
    (torch.float32, 1e-5, 32, 4, 64),
    (torch.bfloat16, 2e-2, 24, 8, 128),      # G = 3 (minitron widths)
    (torch.float32, 1e-5, 24, 8, 128),
    (torch.bfloat16, 2e-2, 56, 8, 128),      # G = 7 (yi widths)
    (torch.float32, 1e-5, 56, 8, 128),
    (torch.bfloat16, 2e-2, 64, 8, 128),      # G = 8 (kimi-k2 widths)
    (torch.float32, 1e-5, 64, 8, 128),
])
def test_decode_kernels_across_chunk_edges(cuda, dtype, atol, H, KV, D):
    """Contexts across the chunk edges up to the table's capacity (4
    chunks): both decode kernels within ``atol`` of their plain versions
    (and one bf16 ulp in bf16), the fused kernel's pools equal, and
    ``paged_attention`` bitwise ``fused_decode_attention`` on the pools
    that one wrote."""
    from repro_torch.kernels import paged_attention as pa
    page = 16
    ctxs = _chunk_ctxs(pa.CHUNK, 4 * pa.CHUNK)
    B, n_max = len(ctxs), 4 * pa.CHUNK // page
    g = torch.Generator(device=cuda).manual_seed(3)
    P = B * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, kn, vn = rnd(B, H, D), rnd(B, KV, D), rnd(B, KV, D)
    kp, vp = rnd(P, page, KV, D), rnd(P, page, KV, D)
    tab = torch.randperm(P - 1, generator=g, device=cuda)
    tab = tab.reshape(B, n_max).to(torch.int32)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=cuda)
    out = pa.paged_attention(q, kp, vp, tab, ctx)
    ref = pa.paged_attention_ref(q, kp, vp, tab, ctx)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o1, k1, v1 = pa.fused_decode_attention(q, kn, vn, k1, v1, tab, ctx - 1)
    o2, k2, v2 = pa.fused_decode_attention_ref(q, kn, vn, k2, v2, tab,
                                               ctx - 1)
    again = pa.paged_attention(q, k1, v1, tab, ctx)
    torch.cuda.synchronize()
    for got, want in ((out, ref), (o1, o2)):
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= atol
        if dtype == torch.bfloat16:
            assert bool((diff <= 2.0 ** -7 * want.float().abs()
                         + 1e-5).all())
    assert torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])
    assert torch.equal(again, o1)


def test_lane_alone_equals_lane_among_64(cuda):
    """Each live lane of a 64-lane serving call (8 live at contexts across
    chunk edges, 56 padding lanes on the all-scrap table) bitwise equal to
    the same lane called alone, for both decode kernels."""
    from repro_torch.kernels import paged_attention as pa
    B, H, KV, D, page, n_max = 64, 32, 4, 64, 16, 16
    ctxs = _chunk_ctxs(pa.CHUNK, n_max * page)[:8]
    live = len(ctxs)
    g = torch.Generator(device=cuda).manual_seed(4)
    P = live * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    q, kn, vn = rnd(B, H, D), rnd(B, KV, D), rnd(B, KV, D)
    kp, vp = rnd(P, page, KV, D), rnd(P, page, KV, D)
    tab = torch.full((B, n_max), P - 1, dtype=torch.int32, device=cuda)
    tab[:live] = torch.arange(live * n_max, dtype=torch.int32,
                              device=cuda).reshape(live, n_max)
    ctx = torch.ones(B, dtype=torch.int32, device=cuda)
    ctx[:live] = torch.tensor(ctxs, dtype=torch.int32, device=cuda)
    att = pa.paged_attention(q, kp, vp, tab, ctx)
    fused, _, _ = pa.fused_decode_attention(q, kn, vn, kp.clone(),
                                            vp.clone(), tab, ctx - 1)
    for i in range(live):
        one = slice(i, i + 1)
        a1 = pa.paged_attention(q[one], kp, vp, tab[one], ctx[one])
        f1, _, _ = pa.fused_decode_attention(q[one], kn[one], vn[one],
                                             kp.clone(), vp.clone(),
                                             tab[one], ctx[one] - 1)
        torch.cuda.synchronize()
        assert torch.equal(a1[0], att[i]) and torch.equal(f1[0], fused[i])


@pytest.mark.parametrize("dtype,atol,B,W,H,KV,D,page,ctxs,widths,lanes", [
    (torch.bfloat16, 2e-2, 4, 5, 32, 4, 64, 16, [1, 16, 17, 300],
     [5, 1, 3, 4], None),
    (torch.float32, 1e-5, 3, 3, 6, 3, 64, 16, [1, 40, 200], [3, 2, 1], None),
    (torch.float32, 1e-5, 2, 4, 8, 1, 128, 8, [9, 60], [4, 4], None),
    # windows across a 64-token tile edge (rows at ctx 62-66, 125-133)
    (torch.bfloat16, 2e-2, 2, 5, 32, 4, 64, 16, [62, 60], [5, 5], None),
    (torch.bfloat16, 2e-2, 2, 9, 32, 4, 64, 16, [125, 120], [9, 9], None),
    (torch.bfloat16, 2e-2, 4, 1, 32, 4, 64, 16, [1, 64, 65, 300],
     [1, 1, 1, 1], None),                                    # W = 1
    (torch.bfloat16, 2e-2, 4, 5, 32, 4, 64, 16, [20, 64, 100, 200],
     [0, 5, 0, 3], None),                   # width 0 on live tables
    # MQA at W = 9: a lane's rows split over blocks
    (torch.float32, 1e-5, 2, 9, 32, 1, 128, 16, [120, 250], [9, 7], None),
    (torch.bfloat16, 2e-2, 2, 9, 32, 1, 128, 16, [60, 250], [9, 6], None),
    # rows of 24 bytes: copied without cp.async
    (torch.bfloat16, 2e-2, 2, 3, 4, 2, 12, 8, [30, 70], [3, 2], None),
    # the serving call: 8 drafted lanes beside 56 padding lanes at width 0
    # on the all-scrap table
    (torch.bfloat16, 2e-2, 8, 5, 32, 4, 64, 16,
     [1, 15, 16, 17, 32, 33, 48, 52], [5, 2, 5, 1, 4, 5, 3, 5], 64),
    # windows straddling 64- and 128-token edges (whatever the chunk
    # length of 64, 128 or 256), G = 3 and G = 7 at D = 128
    (torch.bfloat16, 2e-2, 4, 5, 32, 4, 64, 16, [62, 126, 254, 508],
     [5, 5, 5, 5], None),
    (torch.bfloat16, 2e-2, 3, 9, 32, 4, 64, 16, [120, 250, 380],
     [9, 9, 9], None),
    (torch.float32, 1e-5, 2, 4, 24, 8, 128, 16, [127, 257], [4, 3], None),
    (torch.bfloat16, 2e-2, 2, 3, 56, 8, 128, 16, [128, 382], [3, 3], None),
    # kimi-k2's widths (G = 8, D = 128) in the serving call
    (torch.bfloat16, 2e-2, 8, 5, 64, 8, 128, 16,
     [1, 15, 16, 17, 32, 33, 48, 52], [5, 2, 5, 1, 4, 5, 3, 5], 64),
])
def test_verify_kernel_matches_plain_and_chained_decode(
        cuda, dtype, atol, B, W, H, KV, D, page, ctxs, widths, lanes):
    """Live rows (s < width) within ``atol`` of the plain version and
    bitwise equal to W chained ``fused_decode_attention`` launches (rows
    past a lane's width on the all-scrap table); pools equal to both off
    the scrap page.  Row 0 of lane b sits at context ctxs[b]; ``lanes``
    (default B) adds padding lanes at width 0 on the all-scrap table."""
    from repro_torch.kernels import paged_attention as pa
    g = torch.Generator(device=cuda).manual_seed(2)
    n_max = max(-(-(c + W) // page) for c in ctxs)
    P = B * n_max + 1
    L = lanes or B

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, kn, vn = rnd(L, W, H, D), rnd(L, W, KV, D), rnd(L, W, KV, D)
    kp, vp = rnd(P, page, KV, D), rnd(P, page, KV, D)
    tab = torch.full((L, n_max), P - 1, dtype=torch.int32, device=cuda)
    tab[:B] = torch.randperm(P - 1, generator=g, device=cuda).reshape(
        B, n_max).to(torch.int32)
    pos0 = torch.zeros(L, dtype=torch.int32, device=cuda)
    pos0[:B] = torch.tensor(ctxs, dtype=torch.int32, device=cuda) - 1
    wid = torch.zeros(L, dtype=torch.int32, device=cuda)
    wid[:B] = torch.tensor(widths, dtype=torch.int32, device=cuda)
    before = pa.launches["fused_verify_attention"]
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    k3, v3 = kp.clone(), vp.clone()
    o1, k1, v1 = pa.fused_verify_attention(q, kn, vn, k1, v1, tab, pos0, wid)
    o2, k2, v2 = pa.fused_verify_attention_ref(q, kn, vn, k2, v2, tab, pos0,
                                               wid)
    scrap = torch.full_like(tab, P - 1)
    chained = []
    for s in range(W):
        tab_s = torch.where(wid[:, None] > s, tab, scrap)
        o, k3, v3 = pa.fused_decode_attention(
            q[:, s].contiguous(), kn[:, s].contiguous(),
            vn[:, s].contiguous(), k3, v3, tab_s, pos0 + s)
        chained.append(o)
    torch.cuda.synchronize()
    live = torch.arange(W, device=cuda)[None, :] < wid[:, None]
    assert (o1[live].float() - o2[live].float()).abs().max().item() <= atol
    assert torch.equal(o1[live], torch.stack(chained, dim=1)[live])
    for a, b in ((k1, k2), (v1, v2), (k1, k3), (v1, v3)):
        assert torch.equal(a[:-1], b[:-1])
    assert pa.launches["fused_verify_attention"] == before + 1


class _Replay:
    """Drafts recorded prompt + output streams back (the prefix match's
    continuation), so a run that reproduces them accepts its drafts."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, tokens, k):
        hist = [int(t) for t in tokens]
        for s in self.streams:
            if len(s) > len(hist) and s[:len(hist)] == hist:
                return s[len(hist):len(hist) + k]
        return []


def test_reduced_model_streams_equal_across_modes(cuda):
    """Streams equal across attention modes, decode horizons and
    speculation, with n-gram drafts and with drafts replayed from the
    plain run; the replayed drafts are accepted."""
    import numpy as np

    from repro_torch.configs.archs import reduced_config
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.request import Request, SLOSpec
    from repro_torch.serving.torch_backend import PagedTorchBackend

    rng = np.random.default_rng(0)
    V = reduced_config("tinyllama-1.1b").vocab_size
    # one prompt repeats a motif, so the n-gram drafter proposes
    prompts = {1: rng.integers(0, V, 20).tolist(),
               2: [11, 42, 7, 99] * 5,
               3: rng.integers(0, V, 20).tolist()}

    def streams(fused, decode_steps, spec=0, temperature=0.0, drafter=None):
        be = PagedTorchBackend(num_blocks=16, page=16, max_len=64, seed=0,
                               fused=fused, device=cuda,
                               temperature=temperature, top_k=20,
                               drafter=drafter)
        eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                          EngineConfig(max_batch=4, prefill_budget=32,
                                       decode_steps=decode_steps,
                                       spec_depth_max=spec))
        reqs = [Request(rid=rid, app="chatbot", arrival=0.0,
                        prompt_len=20, true_output_len=10,
                        slo=SLOSpec("throughput", ttlt=1e6))
                for rid in prompts]
        for r in reqs:
            r.meta["prompt_tokens"] = prompts[r.rid]
        eng.load(reqs, [])
        fin = eng.run()
        assert len(fin) == 3
        assert spec == 0 or eng.spec_proposed > 0
        if drafter is not None:
            assert eng.spec_accepted > 0
        return {r.rid: list(be.generated[r.rid]) for r in fin}

    def replay(ref):
        return _Replay([prompts[rid] + ref[rid] for rid in prompts])

    ref = streams(True, 1)
    assert streams(True, 4) == ref
    assert streams(False, 1) == ref
    assert streams(True, 1, spec=4) == ref
    assert streams(True, 4, spec=4) == ref
    assert streams(True, 1, spec=4, drafter=replay(ref)) == ref
    hot = streams(True, 1, temperature=0.8)
    assert streams(True, 1, spec=4, temperature=0.8) == hot
    assert streams(True, 1, spec=4, temperature=0.8,
                   drafter=replay(hot)) == hot


@pytest.mark.parametrize("tp", [2, 4])
def test_reduced_tp_ranks_sharing_the_card_stream_as_tp1(cuda, tp):
    """tp ranks sharing the card (collectives through shared device
    buffers; at tp=4 the reduced model's KV=2 replicates attention): the
    reduced f32 model's streams equal tp=1's on the card, n=4 and spec 4
    included; the ranks' hashes agree and every rank launched the paged
    kernels, its ticket counters back at zero."""
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.request import Request, SLOSpec
    from repro_torch.serving.torch_backend import PagedTorchBackend

    def streams(n, decode_steps=1, spec=0):
        kw = dict(tp=n, devices=[cuda] * n) if n > 1 else dict(device=cuda)
        be = PagedTorchBackend(num_blocks=16, page=16, max_len=64, seed=0,
                               **kw)
        try:
            eng = ServeEngine(be, make_scheduler("tempo",
                                                 use_predictor=False),
                              EngineConfig(max_batch=4, prefill_budget=32,
                                           decode_steps=decode_steps,
                                           spec_depth_max=spec, tp=n))
            reqs = [Request(rid=rid, app="chatbot", arrival=0.0,
                            prompt_len=20, true_output_len=10,
                            slo=SLOSpec("throughput", ttlt=1e6))
                    for rid in (1, 2, 3)]
            reqs[1].meta["prompt_tokens"] = [11, 42, 7, 99] * 5
            eng.load(reqs, [])
            assert len(eng.run()) == 3
            assert spec == 0 or eng.spec_proposed > 0
            if n > 1:
                stats = be.rank_stats()
                assert {st["data"] for st in stats} == {"shared"}
                assert len({st["digest"] for st in stats}) == 1
                assert all(st["tickets"] == 0 and
                           st["launches"]["fused_decode_attention"] > 0
                           for st in stats)
            return {rid: list(t) for rid, t in be.generated.items()}
        finally:
            be.close()

    ref = streams(1)
    assert streams(tp) == ref
    assert streams(tp, decode_steps=4) == ref
    assert streams(tp, spec=4) == ref


# the bf16 (tensor-core) body at every head-dim pair it is built for, GQA
# groups of 1, 3 and 8, S of one key, a ragged tile and a long ragged run
_HEAD_DIMS = [(64, 64), (96, 64), (128, 128), (64, 128), (96, 128),
              (128, 64), (16, 16), (24, 16), (192, 128)]
_BF16_SWEEP = [(torch.bfloat16, causal, 1 if S > 100 else 2, S, 2 * G, 2, Dk,
                Dv)
               for Dk, Dv in _HEAD_DIMS for G in (1, 3, 8)
               for S in (1, 77, 1000) for causal in (True, False)]


@pytest.mark.parametrize("dtype,causal,B,S,H,KV,Dk,Dv", [
    (torch.float32, True, 2, 128, 4, 4, 64, 64),     # the reference sweep
    (torch.bfloat16, True, 1, 256, 8, 2, 64, 64),
    (torch.float32, True, 2, 256, 4, 1, 128, 128),
    (torch.bfloat16, True, 1, 512, 8, 8, 128, 128),
    (torch.float32, False, 1, 128, 4, 4, 64, 64),    # non-causal
    (torch.float32, True, 2, 77, 4, 2, 16, 16),      # ragged S, reduced dims
    (torch.bfloat16, False, 1, 1000, 8, 2, 64, 64),  # ragged, non-causal
    (torch.float32, True, 1, 300, 24, 8, 128, 128),  # G = 3
    (torch.bfloat16, True, 2, 200, 40, 40, 96, 64),  # MLA head dims
    (torch.float32, True, 2, 33, 4, 4, 24, 16),      # reduced MLA dims
    (torch.float32, True, 3, 1, 4, 2, 64, 64),       # S = 1
    (torch.float32, True, 1, 300, 16, 16, 192, 128),  # deepseek MLA dims
    (torch.float32, False, 2, 77, 4, 2, 192, 128),
] + _BF16_SWEEP)
def test_flash_kernel_matches_plain_version(cuda, dtype, causal, B, S, H,
                                            KV, Dk, Dv):
    """The reference's tolerances (``tests/test_kernels.py``): 3e-5 in f32,
    2.5e-2 in bf16."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(S + Dk)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, k, v = rnd(B, S, H, Dk), rnd(B, S, KV, Dk), rnd(B, S, KV, Dv)
    before = fa.launches["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    assert out.shape == (B, S, H, Dv) and out.dtype == dtype
    atol = 3e-5 if dtype == torch.float32 else 2.5e-2
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Dk,Dv", [(64, 64), (96, 64), (192, 128)])
@pytest.mark.parametrize("i", [100, 127, 128])
def test_flash_kernel_causal_mask(cuda, dtype, Dk, Dv, i):
    """Causality on the card: K/V changed at positions past i leave rows
    0..i bitwise equal; changed at i, they leave rows before i equal and
    change row i.  i sits inside a 64-key tile, on its last key and on the
    first key of the next."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, KV = 2, 200, 8, 2
    g = torch.Generator(device=cuda).manual_seed(i + Dk)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, k, v = rnd(B, S, H, Dk), rnd(B, S, KV, Dk), rnd(B, S, KV, Dv)
    out = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, i + 1:], v2[:, i + 1:] = rnd(B, S - i - 1, KV, Dk), \
        rnd(B, S - i - 1, KV, Dv)
    later = fa.flash_attention(q, k2, v2)
    k2[:, i], v2[:, i] = rnd(B, KV, Dk), rnd(B, KV, Dv)
    at_i = fa.flash_attention(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(later[:, :i + 1], out[:, :i + 1])
    assert not torch.equal(later[:, i + 1:], out[:, i + 1:])
    assert torch.equal(at_i[:, :i], out[:, :i])
    assert (at_i[:, i] != out[:, i]).any(dim=-1).all()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "minicpm3-4b",
                                  "kimi-k2-1t-a32b", "deepseek-v2-lite-16b"])
def test_reduced_fullseq_forward_on_card_matches_cpu(cuda, arch):
    """Reduced f32 model: logits, prefill and decode_step on the card
    within 1e-4 of the CPU's, with one flash launch per layer per
    forward."""
    from repro_torch.configs.archs import reduced_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.convert import tree_map
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0))
    dev = tree_map(lambda t: t.to(cuda), cpu)
    B, S = 2, 70
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    before = fa.launches["flash_attention"]
    lg = m.logits(dev, {"tokens": toks.to(cuda)})
    assert fa.launches["flash_attention"] == before + cfg.num_layers
    ref = m.logits(cpu, {"tokens": toks})
    assert (lg.cpu() - ref).abs().max().item() <= 1e-4
    outs = []
    for params, d in ((cpu, "cpu"), (dev, cuda)):
        _, caches = m.prefill(params, {"tokens": toks[:, :S - 1].to(d)})
        grown = m.init_caches(B, S, d)
        tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)]
                 .copy_(c), grown, caches)
        logits, _ = m.decode_step(params, grown, toks[:, S - 1:].to(d),
                                  S - 1)
        outs.append(logits.cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4
    assert (outs[1] - ref[:, S - 1]).abs().max().item() <= 2e-2


def _bwd_within(fa, got, q, k, v, o, lse, do, causal):
    """Whether each of got's (dq, dk, dv) is within ``fa.bwd_error``'s
    bound of the plain backward in f32 on f32 copies of the inputs: f32
    2e-5 of the tensor's largest value (at least 1), sums in another order
    (f32 FMAs vs the plain version's cuBLAS GEMMs); bf16 2^-8 |ref| + 2^-6
    rss + 1e-4 (P and dS rounded to bf16 as operands, the output rounded
    once)."""
    f = [t.float() for t in (q, k, v, o)] + [lse, do.float()]
    ref = fa.flash_attention_bwd_ref(*f, causal=causal)
    rss = (fa.flash_attention_bwd_rss(*f, causal=causal)
           if q.dtype == torch.bfloat16 else (None,) * 3)
    return all(fa.bwd_error(a, r, e) <= 1 for a, r, e in zip(got, ref, rss))


@pytest.mark.parametrize("dtype,causal,B,S,H,KV,Dk,Dv", [
    (torch.float32, True, 2, 77, 4, 2, 16, 16),      # reduced GQA, ragged
    (torch.float32, False, 2, 77, 4, 2, 16, 16),
    (torch.float32, True, 2, 33, 4, 4, 24, 16),      # reduced MLA
    (torch.float32, True, 1, 200, 8, 1, 64, 64),     # G = 8, ragged
    (torch.float32, False, 1, 130, 8, 8, 96, 64),    # MLA head dims
    (torch.float32, True, 3, 1, 4, 2, 64, 64),       # S = 1
    (torch.bfloat16, True, 2, 256, 8, 1, 64, 64),
    (torch.bfloat16, False, 1, 65, 8, 8, 96, 64),
    (torch.bfloat16, True, 1, 63, 4, 2, 24, 16),
    (torch.float32, True, 2, 77, 6, 2, 128, 128),    # G = 3 at Dh 128
    (torch.bfloat16, True, 2, 77, 6, 2, 128, 128),
    (torch.bfloat16, False, 1, 130, 4, 4, 128, 128),
    (torch.float32, True, 1, 100, 4, 4, 192, 128),   # deepseek's MLA dims
    (torch.bfloat16, True, 1, 200, 4, 4, 192, 128),
    (torch.bfloat16, False, 2, 65, 4, 2, 192, 128),
])
def test_flash_bwd_kernel_matches_plain_version(cuda, dtype, causal, B, S,
                                                H, KV, Dk, Dv):
    """The backward kernel against ``flash_attention_bwd_ref`` on the same
    inputs (the kernel forward's output and lse), one launch a call, and
    two calls bitwise equal (no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(S + Dk + 7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, k, v = rnd(B, S, H, Dk), rnd(B, S, KV, Dk), rnd(B, S, KV, Dv)
    do = rnd(B, S, H, Dv)
    o, lse = fa._forward(q, k, v, causal, Dk ** -0.5, with_lse=True)
    lse_ref = fa.flash_attention_lse_ref(q, k, causal=causal)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    before = fa.launches["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_bwd"] == before + 2
    for a, b, t in zip(got, again, (q, k, v)):
        assert a.dtype == dtype and a.shape == t.shape
        assert torch.equal(a, b)
    assert _bwd_within(fa, got, q, k, v, o, lse, do, causal)


def test_flash_function_grads_match_autograd_on_card(cuda):
    """f32: ``FlashAttentionFn``'s gradients (forward and backward
    kernels) against torch autograd through ``flash_attention_ref``."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=cuda)
               for s in ((2, 150, 8, 64), (2, 150, 2, 64), (2, 150, 2, 64)))
    do = torch.randn(2, 150, 8, 64, generator=g, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves), leaves, do)
    ref = torch.autograd.grad(fa.flash_attention_ref(*ref_leaves),
                              ref_leaves, do)
    for a, b in zip(got, ref):
        assert fa.bwd_error(a, b) <= 1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "minicpm3-4b",
                                  "kimi-k2-1t-a32b", "deepseek-v2-lite-16b"])
def test_reduced_loss_grads_on_card_match_cpu(cuda, arch):
    """Reduced f32 model: ``Model.loss`` and every gradient on the card
    (flash forward and backward kernels, one backward launch per layer)
    within 1e-5 of the CPU's (the plain versions), every gradient leaf
    non-zero."""
    from repro_torch.configs.archs import reduced_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.convert import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 70), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    before = fa.launches["flash_attention_bwd"]
    loss, grads = value_and_grad(
        m.loss, tree_map(lambda t: t.to(cuda), cpu),
        {k: t.to(cuda) for k, t in batch.items()})
    assert fa.launches["flash_attention_bwd"] == before + cfg.num_layers
    ref_loss, ref = value_and_grad(m.loss, cpu, batch)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert (a.cpu() - b).abs().max().item() <= 1e-5
        assert bool(a.abs().sum() > 0)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b",
                                  "musicgen-medium", "pixtral-12b"])
def test_reduced_recurrent_and_frontend_families_on_card_match_cpu(cuda,
                                                                   arch):
    """Reduced f32 jamba, xlstm, musicgen and pixtral (batches by
    frontend): logits, prefill and two decode steps on the card within
    1e-4 of the CPU's (the caches written in place on both), and
    ``Model.loss`` with every gradient within 1e-5 of the CPU's, one flash
    backward launch per attention layer."""
    from repro_torch.configs.archs import reduced_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.convert import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from _torch_batches import numpy_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0))
    dev = tree_map(lambda t: t.to(cuda), cpu)
    B, S = 2, 70
    batch = {k: torch.from_numpy(v)
             for k, v in numpy_batch(m, B, S, 1).items()}
    labels = batch.pop("labels")
    toks = torch.randint(0, cfg.vocab_size, (B, 2), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    pre = {k: v[:, :-2] if k != "patches" else v for k, v in batch.items()}
    outs = []
    for params, d in ((cpu, "cpu"), (dev, cuda)):
        got = [m.logits(params, {k: v.to(d) for k, v in batch.items()})]
        _, caches = m.prefill(params, {k: v.to(d) for k, v in pre.items()})
        grown = m.init_caches(B, S, d)
        tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)]
                 .copy_(c), grown, caches)
        for i in range(2):
            logits, _ = m.decode_step(params, grown, toks[:, i:i + 1].to(d),
                                      S - 2 + i)
            got.append(logits)
        outs.append([t.cpu() for t in got + tree_leaves(grown)])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4
    batch["labels"] = labels
    before = fa.launches["flash_attention_bwd"]
    loss, grads = value_and_grad(m.loss, dev, {k: v.to(cuda)
                                               for k, v in batch.items()})
    n_attn = sum(mx == "attn" for mx, _ in cfg.unit_pattern) * cfg.num_units
    assert fa.launches["flash_attention_bwd"] == before + n_attn
    ref_loss, ref = value_and_grad(m.loss, cpu, batch)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert (a.cpu() - b).abs().max().item() <= 1e-5


_FLEET_SPEC = dict(rate=1.5, duration=6.0, seed=0, mix=(2, 1, 1),
                   prompt_cap=40, output_cap=12, slo_scale=20.0)


@pytest.mark.parametrize("cluster", [
    dict(router="disagg", roles=["prefill", "decode"]),
    dict(router="slo-margin", n_replicas=2)], ids=["disagg", "slo-margin"])
def test_reduced_fleet_on_card_streams_equal_one_replica(cuda, cluster):
    """A 2-replica reduced fleet on the card (each replica builds its own
    backend from the same seed): merged streams equal one replica's, with
    migrations under disagg and both replicas routed under slo-margin."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.run import (BackendSpec, ClusterSpec,
                                         ExperimentSpec, run, run_cluster)
    from repro_torch.serving.torch_backend import PagedTorchBackend
    from repro_torch.serving.workload import WorkloadSpec

    kw = dict(num_blocks=64, page=16, max_len=128, seed=0)
    engine = EngineConfig(max_batch=8, prefill_budget=32)

    def merged(sink):
        return sorted((rid, tuple(t)) for be in sink
                      for rid, t in be.generated.items())

    one = PagedTorchBackend(device=cuda, **kw)
    run(ExperimentSpec(scheduler="tempo", workload=WorkloadSpec(**_FLEET_SPEC),
                       engine=engine, backend=BackendSpec(kind=one),
                       warmup=64))
    sink = []
    before = pa.launches["fused_decode_attention"]
    f = run_cluster(ExperimentSpec(
        scheduler="tempo", workload=WorkloadSpec(**_FLEET_SPEC),
        engine=engine, warmup=64, cluster=ClusterSpec(**cluster),
        backend=BackendSpec(kind="torch", kwargs=kw, sink=sink)))
    assert pa.launches["fused_decode_attention"] > before
    assert {be.device.type for be in sink} == {"cuda"}
    if cluster["router"] == "disagg":
        assert f.fleet.migrated_in > 0
    else:
        assert min(f.routed.values()) > 0
    assert merged(sink) == merged([one])
    assert pa.ticket_sum() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_migration_round_trip_on_card(cuda, dtype):
    """Pages exported from one backend on the card and imported into
    another at other indices are bitwise equal, live and swapped; bf16
    crosses the host as its int16 patterns."""
    import numpy as np

    from repro_torch.models.convert import tree_leaves
    from repro_torch.serving.torch_backend import PagedTorchBackend

    a, b = (PagedTorchBackend(num_blocks=64, page=16, max_len=128, seed=0,
                              device=cuda) for _ in range(2))
    g = torch.Generator(device=cuda).manual_seed(0)
    for be in (a, b):
        for leaf in tree_leaves(be.pages):
            leaf.data = torch.randn(leaf.shape, generator=g, device=cuda,
                                    dtype=torch.float32).to(dtype)

    def pages(be, table):
        return [leaf[:, table] if leaf.ndim == 5 else leaf[table]
                for leaf in tree_leaves(be.pages)]

    ta, tb = [0, 1, 2], [40, 9, 33]
    payload = a.kv_export_pages(7, ta)
    want = np.int16 if dtype == torch.bfloat16 else np.float32
    assert {x.dtype for x in tree_leaves(payload["pages"])} == \
        {np.dtype(want)}
    b.kv_import_pages(7, payload, tb)
    assert all(torch.equal(x, y) for x, y in zip(pages(a, ta), pages(b, tb)))
    ts, tb2 = [3, 4], [60, 12]
    a.kv_swap_out(8, ts, 32)
    b.kv_import_pages(8, a.kv_export_pages(8, []), None)
    b.kv_swap_in(8, tb2)
    assert all(torch.equal(x, y) for x, y in zip(pages(a, ts),
                                                  pages(b, tb2)))


# ---------------------------------------------------------------------------
# the roofline counter on the card, expert parallelism over ranks on it
# ---------------------------------------------------------------------------
def test_roofline_decode_step_on_the_card(cuda):
    """The fused decode kernel reports its cost (not opaque); the counts
    equal the CPU run's (the same ops, the kernel's formula in place of its
    plain version's ops)."""
    from repro_torch.launch.roofline import roofline_decode_step

    kw = dict(batch=8, num_blocks=16, page=8, max_len=32, repeats=2,
              steps=2)
    rec = roofline_decode_step(device="cuda", **kw)
    cpu = roofline_decode_step(device="cpu", **kw)
    assert not rec["hlo_opaque"] and rec["device"].startswith("cuda")
    assert rec["kernel_reports"] == {"fused_decode_attention": 1}
    assert rec["hlo_flops_per_chip"] == cpu["hlo_flops_per_chip"]
    assert rec["measured_s"] > 0 and rec["multi_measured_s"] > 0


def test_counter_sees_the_flash_kernels_launch_and_report(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import CostCounter

    q = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=cuda, requires_grad=True)
    v = torch.randn(1, 64, 2, 64, device=cuda, requires_grad=True)
    with CostCounter() as c:
        fa.flash_attention(q, k, v).sum().backward()
    assert c.launched == 2 and c.device_reports == 2 and not c.opaque
    assert c.kernels == {"flash_attention": 1, "flash_attention_bwd": 1}


def _ep_rank_cuda(groups, rank, mesh, cases):
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.models.moe import ep_shards, moe_ep

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for cfg, x, p, phase, dtp in cases:
        ctx = make_ctx(cfg, mesh, phase, decode_tp=dtp,
                       ep_group=groups["model"], fsdp_group=groups["data"])
        xs, ps = ep_shards(x.to(mesh.devices[rank]),
                           {k: t.to(mesh.devices[rank])
                            for k, t in p.items()}, cfg, ctx, rank)
        st = {}
        y = moe_ep(xs, ps, cfg, ctx, stats=st)
        out.append((y.cpu(), int(st["kept"])))
    return out


def test_moe_ep_ranks_sharing_the_card_equal_the_plain_version(cuda):
    """Reduced deepseek-v2-lite, f32, a (2, 2) grid of ranks on cuda:0:
    'weights' (dropping at capacity factor 0.5) and decode 'tokens' mode
    against ``moe_ep_ref`` on the card."""
    import dataclasses

    from repro_torch.configs.archs import reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import make_ctx
    from repro_torch.models.moe import ep_shards, moe_ep_ref
    from repro_torch.serving.tp import run_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config("deepseek-v2-lite-16b"),
                              capacity_factor=0.5)
    g = torch.Generator().manual_seed(0)
    E, d, F = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": torch.randn(d, E, generator=g),
         "w_gate": torch.randn(E, d, F, generator=g) * 0.1,
         "w_up": torch.randn(E, d, F, generator=g) * 0.1,
         "w_down": torch.randn(E, F, d, generator=g) * 0.1}
    cases = [(cfg, torch.randn(2, 16, d, generator=g), p, "prefill", False),
             (cfg, torch.randn(4, 1, d, generator=g), p, "decode", True)]
    mesh = make_local_mesh(model=2, data=2, device="cuda:0")
    results, codes = run_grid(_ep_rank_cuda, mesh, (mesh, cases))
    assert codes == [0, 0, 0]
    for i, (_, x, _, phase, dtp) in enumerate(cases):
        ctx = make_ctx(cfg, mesh, phase, decode_tp=dtp)
        pc = {k: t.to(cuda) for k, t in p.items()}
        st = {}
        y = moe_ep_ref(x.to(cuda), pc, cfg, ctx, stats=st)
        assert sum(r[i][1] for r in results) == int(st["kept"])
        for r in range(4):
            want = ep_shards(y, pc, cfg, ctx, r)[0].cpu()
            assert torch.allclose(results[r][i][0], want, rtol=0, atol=1e-5)


# -- the decode forward's CUDA graphs (models/paged_graphs.py) -------------
def _graph_backend(cuda, arch="tinyllama-1.1b", layers=4, **cfg_kw):
    """A bf16 backend on the card of ``arch`` reduced, at ``layers``
    layers."""
    import dataclasses

    from repro_torch.configs.archs import reduced_config
    from repro_torch.serving.torch_backend import PagedTorchBackend

    cfg = dataclasses.replace(reduced_config(arch), num_layers=layers,
                              dtype="bfloat16", **cfg_kw)
    return PagedTorchBackend(config=cfg, num_blocks=64, page=16, max_len=128,
                             seed=0, device=cuda)


def _counts(m, kind):
    """(captures, replays) of ``kind`` in the model's graph table."""
    return m.graphs.captures[kind], m.graphs.replays[kind]


def _graph_inputs(be, B, step):
    """Decode inputs of B lanes: the first eight live at random positions
    on tables of their own pages, the rest padding on the scrap table."""
    import numpy as np

    g = np.random.default_rng(step)
    toks = g.integers(0, be.cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.zeros(B, np.int32)
    tabs = np.full((B, be.n_max), be.scrap, np.int32)
    pages = g.permutation(be.num_blocks)
    for b in range(8):
        pos[b] = g.integers(0, be.max_len)
        tabs[b] = pages[b * be.n_max:(b + 1) * be.n_max]
    return [be._dev(a) for a in (toks, pos, tabs)]


def _pool_clone(pages):
    from repro_torch.models.convert import tree_map
    return tree_map(lambda t: t.clone(), pages)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("B", [64, 128])
def test_decode_graph_replays_bitwise_the_eager_forward(cuda, arch, B):
    """Calls of one shape: the first eager, the second captured and
    replayed, the rest replayed; each call's logits and pools bitwise
    ``_decode_forward``'s on a copy of the pools (but the scrap page, where
    the padding lanes' writes race), and the paged launch counter up by the
    layers on every call."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.convert import tree_leaves

    be = _graph_backend(cuda, arch)
    m, L = be.model, be.cfg.num_layers
    for step in range(4):
        toks, pos, tabs = _graph_inputs(be, B, step)
        ref = _pool_clone(be.pages)
        want, ref = m._decode_forward(be.params, ref, toks, pos, tabs,
                                      fused=True)
        before = pa.launches["fused_decode_attention"]
        got, pages = m.decode_paged(be.params, be.pages, toks, pos, tabs,
                                    fused=True)
        torch.cuda.synchronize()
        assert pages is be.pages and torch.equal(got, want)
        assert all(torch.equal(a[..., :-1, :, :, :], b[..., :-1, :, :, :])
                   for a, b in zip(tree_leaves(pages), tree_leaves(ref)))
        assert pa.launches["fused_decode_attention"] == before + L
        assert _counts(m, "decode") == (int(step >= 1), step)
    assert pa.ticket_sum() == 0


def test_decode_graphs_serve_the_eager_streams(cuda, monkeypatch):
    """An engine run streams the same tokens with graphs as with the
    eager forward forced; the graphed run replays."""
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.models import paged_graphs as pg
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.request import Request, SLOSpec

    def streams():
        be = _graph_backend(cuda)
        eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                          EngineConfig(max_batch=4, prefill_budget=32,
                                       decode_steps=2))
        eng.load([Request(rid=i + 1, app="chatbot", arrival=0.0,
                          prompt_len=20 + 7 * i, true_output_len=12,
                          slo=SLOSpec("throughput", ttlt=1e6))
                  for i in range(3)], [])
        fin = eng.run()
        assert len(fin) == 3
        return be.model, {r.rid: list(be.generated[r.rid]) for r in fin}

    m, graphed = streams()
    captures, replays = _counts(m, "decode")
    assert captures == 1 and replays > 5
    monkeypatch.setattr(pg, "usable", lambda *a: False)
    m, eager = streams()
    assert m.graphs.replays["decode"] == 0
    assert graphed == eager


def test_new_params_drop_the_decode_graphs_and_recapture(cuda):
    be = _graph_backend(cuda)
    m = be.model
    toks, pos, tabs = (a.cpu().numpy() for a in _graph_inputs(be, 64, 0))
    for _ in range(3):
        be.decode_logits(toks, pos, tabs)
    assert m.graphs.captures["decode"] == 1 and len(m.graphs.graphs) == 1
    be.load_params(m.init(torch.Generator(device=cuda).manual_seed(1)))
    got = be.decode_logits(toks, pos, tabs)         # eager: graphs dropped
    assert not m.graphs.graphs and m.graphs.captures["decode"] == 1
    ref = _pool_clone(be.pages)
    args = [be._dev(a) for a in (toks, pos, tabs)]
    want, _ = m._decode_forward(be.params, ref, *args, fused=True)
    assert torch.equal(got, want)
    assert torch.equal(be.decode_logits(toks, pos, tabs), want)   # capture
    assert torch.equal(be.decode_logits(toks, pos, tabs), want)   # replay
    assert m.graphs.captures["decode"] == 2


def test_decode_graph_replay_allocates_only_its_logits(cuda):
    """A replay makes one allocation, the caller's copy of the logits,
    and reads the f32 head the eager call made: no head copy (here 8x
    the logits)."""
    be = _graph_backend(cuda, d_model=512, num_heads=8, num_kv_heads=2)
    m = be.model
    args = _graph_inputs(be, 64, 0)
    for _ in range(2):
        m.decode_paged(be.params, be.pages, *args, fused=True)
    head = m._head[2]
    torch.cuda.synchronize()
    stats0 = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    logits, _ = m.decode_paged(be.params, be.pages, *args, fused=True)
    torch.cuda.synchronize()
    stats1 = torch.cuda.memory_stats()
    assert m.graphs.replays["decode"] == 2 and m._head[2] is head
    assert stats1["allocation.all.allocated"] \
        - stats0["allocation.all.allocated"] == 1
    assert torch.cuda.max_memory_allocated() - base <= \
        logits.numel() * 4 + 512 < head.numel() * 4


def test_ticket_buffer_a_graph_reads_outlives_a_wider_launch(cuda,
                                                             monkeypatch):
    """A ticket buffer handed to a paged launch stays allocated at its
    address after a wider launch takes a bigger one: a CUDA graph that
    captured the first launch reads its counters there."""
    import gc
    import weakref

    from repro_torch.kernels import paged_attention as pa

    monkeypatch.setattr(pa, "_tickets", {})
    H, KV, D, page = 32, 4, 64, 16
    n_max = 4 * pa.CHUNK // page        # four chunks: every launch merges
    g = torch.Generator(device=cuda).manual_seed(5)

    def launch(B):
        P = B * n_max + 1

        def rnd(*shape):
            return torch.randn(shape, generator=g,
                               device=cuda).to(torch.bfloat16)

        q, kp, vp = rnd(B, H, D), rnd(P, page, KV, D), rnd(P, page, KV, D)
        tab = torch.arange(B * n_max, dtype=torch.int32,
                           device=cuda).reshape(B, n_max)
        ctx = torch.full((B,), n_max * page, dtype=torch.int32, device=cuda)
        pa.paged_attention(q, kp, vp, tab, ctx)
        torch.cuda.synchronize()
        return q.device

    dev = launch(1)
    first = weakref.ref(pa._tickets[dev][-1])
    ptr, size = first().data_ptr(), first().numel()
    launch(64)
    gc.collect()
    held = pa._tickets[dev]
    assert len(held) == 2 and held[-1].numel() > size
    assert first() is held[0] and held[0].data_ptr() == ptr
    assert pa.ticket_sum() == 0


def test_profiler_sees_a_replay_launch_one_paged_kernel_per_layer(cuda):
    """Under ``torch.profiler``, one replay's ``paged_kernel`` operations
    on the device, one per layer, each correlated to the one
    ``cudaGraphLaunch`` of the call."""
    from torch.autograd import DeviceType

    be = _graph_backend(cuda)
    m, L = be.model, be.cfg.num_layers
    args = _graph_inputs(be, 64, 0)
    for _ in range(2):
        m.decode_paged(be.params, be.pages, *args, fused=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        m.decode_paged(be.params, be.pages, *args, fused=True)
        torch.cuda.synchronize()
    events = prof.events()
    launch = {e.id: e.name for e in events
              if e.device_type != DeviceType.CUDA and e.name.startswith("cu")}
    paged = [e for e in events if e.device_type == DeviceType.CUDA
             and "paged_kernel" in e.name]
    assert len(paged) == L
    assert len({e.id for e in paged}) == 1
    assert all(launch.get(e.id, "").startswith("cudaGraphLaunch")
               for e in paged)


# -- the prefill forward's CUDA graphs ---------------------------------------
def _prompt_chunks(be, chunking, step):
    """A prompt of sum(chunking) tokens on a table of its own pages, cut
    into 64-row calls of ``chunking``: (tokens, start, n) each, and the
    table."""
    import numpy as np

    from repro_torch.serving.torch_backend import ROWS

    g = np.random.default_rng(step)
    prompt = g.integers(0, be.cfg.vocab_size, sum(chunking)).astype(np.int32)
    tab = be._dev(g.permutation(be.num_blocks)[:be.n_max].astype(np.int32))
    calls, start = [], 0
    for n in chunking:
        toks = np.zeros((1, ROWS), np.int32)
        toks[0, :n] = prompt[start:start + n]
        calls.append((be._dev(toks), start, n))
        start += n
    return calls, tab


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b"])
def test_prefill_graph_replays_write_the_eager_pages_across_chunkings(
        cuda, arch):
    """One prompt written under three chunkings on the backend's pool:
    the first call eager, the second captured and replayed, the rest
    replayed; after each chunking the pools bitwise the eager int-argument
    forward's on a copy (but the scrap page, where padding rows' writes
    race), and the prompt's KV bitwise the same under every chunking."""
    from repro_torch.models.convert import tree_leaves

    be = _graph_backend(cuda, arch)
    m = be.model
    prompt_kv = []
    for chunking in ([64, 56], [30, 50, 40], [64, 17, 39]):
        calls, tab = _prompt_chunks(be, chunking, 0)
        ref = _pool_clone(be.pages)
        for toks, start, n in calls:
            ref = m._prefill_forward(be.params, ref, toks, start, tab, n)
            pages = m.prefill_paged(be.params, be.pages, toks, start, tab, n)
            assert pages is be.pages
        torch.cuda.synchronize()
        assert all(torch.equal(a[..., :-1, :, :, :], b[..., :-1, :, :, :])
                   for a, b in zip(tree_leaves(be.pages), tree_leaves(ref)))
        used = tab[:-(-120 // be.page)].long()
        prompt_kv.append([t[..., used, :, :, :].clone()
                          for t in tree_leaves(be.pages)])
    assert _counts(m, "prefill") == (1, 7)
    assert _counts(m, "decode") == (0, 0)
    for kv in prompt_kv[1:]:
        assert all(torch.equal(a, b) for a, b in zip(prompt_kv[0], kv))


def test_prefill_graphs_serve_the_eager_streams(cuda, monkeypatch):
    """An engine run of prompts of several chunks streams the same tokens
    with graphs as with the eager forwards forced; every prefill call of
    the graphed run but the first replays."""
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.models import paged_graphs as pg
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.request import Request, SLOSpec

    def streams():
        be = _graph_backend(cuda)
        eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                          EngineConfig(max_batch=4, prefill_budget=48))
        eng.load([Request(rid=i + 1, app="chatbot", arrival=0.0,
                          prompt_len=60 + 21 * i, true_output_len=10,
                          slo=SLOSpec("throughput", ttlt=1e6))
                  for i in range(3)], [])
        fin = eng.run()
        assert len(fin) == 3
        return be, {r.rid: list(be.generated[r.rid]) for r in fin}

    be, graphed = streams()
    m = be.model
    assert be.n_prefill_dispatches > 4
    assert _counts(m, "prefill") == (1, be.n_prefill_dispatches - 1)
    monkeypatch.setattr(pg, "usable", lambda *a: False)
    be, eager = streams()
    assert be.model.graphs.replays["prefill"] == 0
    assert graphed == eager


def test_prefill_graph_replay_allocates_nothing(cuda):
    """A replay copies its tokens and table into the graph's buffers and
    fills its start and length there: the call allocates nothing."""
    be = _graph_backend(cuda)
    m = be.model
    calls, tab = _prompt_chunks(be, [64, 64, 64], 0)
    for toks, start, n in calls[:2]:
        m.prefill_paged(be.params, be.pages, toks, start, tab, n)
    toks, start, n = calls[2]
    torch.cuda.synchronize()
    stats0 = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m.prefill_paged(be.params, be.pages, toks, start, tab, n)
    torch.cuda.synchronize()
    stats1 = torch.cuda.memory_stats()
    assert m.graphs.replays["prefill"] == 2
    assert stats1["allocation.all.allocated"] \
        == stats0["allocation.all.allocated"]
    assert torch.cuda.max_memory_allocated() == base
