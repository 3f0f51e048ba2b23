"""The port's CUDA kernels on the card: each against its plain PyTorch
version (the verify kernel also bitwise against chained decode-kernel
launches), and the reduced model's token streams equal across attention
modes, decode horizons and speculation.  Marked ``cuda``; skips without a
GPU.  Run on the GPU machine with

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


@pytest.mark.parametrize("dtype,atol,B,W,H,KV,D,page,ctxs,widths", [
    (torch.bfloat16, 2e-2, 4, 5, 32, 4, 64, 16, [1, 16, 17, 300],
     [5, 1, 3, 4]),
    (torch.float32, 1e-5, 3, 3, 6, 3, 64, 16, [1, 40, 200], [3, 2, 1]),
    (torch.float32, 1e-5, 2, 4, 8, 1, 128, 8, [9, 60], [4, 4]),
])
def test_verify_kernel_matches_plain_and_chained_decode(
        cuda, dtype, atol, B, W, H, KV, D, page, ctxs, widths):
    """Live rows (s < width) within ``atol`` of the plain version and
    bitwise equal to W chained ``fused_decode_attention`` launches (rows
    past a lane's width on the all-scrap table); pools equal to both off
    the scrap page.  Row 0 of lane b sits at context ctxs[b]."""
    from repro_torch.kernels import paged_attention as pa
    g = torch.Generator(device=cuda).manual_seed(2)
    n_max = max(-(-(c + W) // page) for c in ctxs)
    P = B * n_max + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, kn, vn = rnd(B, W, H, D), rnd(B, W, KV, D), rnd(B, W, KV, D)
    kp, vp = rnd(P, page, KV, D), rnd(P, page, KV, D)
    tab = torch.randperm(P - 1, generator=g, device=cuda)
    tab = tab.reshape(B, n_max).to(torch.int32)
    pos0 = torch.tensor(ctxs, dtype=torch.int32, device=cuda) - 1
    wid = torch.tensor(widths, dtype=torch.int32, device=cuda)
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
