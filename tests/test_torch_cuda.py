"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the reduced model's token streams equal across attention
modes and decode horizons.  Marked ``cuda``; skips without a GPU.  Run on
the GPU machine with

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


def test_reduced_model_streams_equal_across_modes(cuda):
    from repro_torch.core.baselines import make_scheduler
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.request import Request, SLOSpec
    from repro_torch.serving.torch_backend import PagedTorchBackend

    def streams(fused, decode_steps):
        be = PagedTorchBackend(num_blocks=16, page=16, max_len=64, seed=0,
                               fused=fused, device=cuda)
        eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                          EngineConfig(max_batch=4, prefill_budget=32,
                                       decode_steps=decode_steps))
        eng.load([Request(rid=i + 1, app="chatbot", arrival=0.0,
                          prompt_len=20, true_output_len=10,
                          slo=SLOSpec("throughput", ttlt=1e6))
                  for i in range(3)], [])
        fin = eng.run()
        assert len(fin) == 3
        return {r.rid: list(be.generated[r.rid]) for r in fin}

    ref = streams(True, 1)
    assert streams(True, 4) == ref
    assert streams(False, 1) == ref
