"""Speculative decoding and seeded sampling in the PyTorch port, on the CPU,
against the JAX package: the threefry generator bit for bit, the sampler
and the accept/reject step token for token, the plain verify attention
against the Pallas kernel in interpret mode, the verify forward against
the reference's and bitwise against the port's own decode forward, and
``PagedTorchBackend``'s speculative streams equal to plain decoding and to
``PagedJaxBackend``'s.  Inputs are made with numpy from fixed seeds; the
models are the reduced tinyllama in f32 with the JAX package's weights."""

import functools
import hashlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.kernels.paged_attention import \
    fused_verify_attention as j_verify  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serving.backend import Sampler as JSampler  # noqa: E402
from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.convert import (pages_from_numpy,  # noqa: E402
                                        params_from_numpy, tree_map)
from repro_torch.models.model import build_model, verify_slabs  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving.backend import Sampler  # noqa: E402
from repro_torch.serving.drafter import NullDrafter  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving.kvcache import BlockManager  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402

ARCH = "tinyllama-1.1b"
F32_EPS = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=1)
def _jax_weights():
    """The JAX package's reduced-model weights for seed 0 (what
    ``PagedJaxBackend(seed=0)`` serves), as numpy."""
    jm = j_build(j_reduced(ARCH))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------
def _keys(seed, rids, poss):
    """(port key, jax keys) of fold_in(fold_in(PRNGKey(seed), rid), pos)."""
    key = prng.prng_key(seed, len(rids), "cpu")
    key = prng.fold_in(prng.fold_in(key, _t(rids)), _t(poss))
    base = jax.random.PRNGKey(seed)
    jkeys = jax.vmap(lambda r, p: jax.random.fold_in(
        jax.random.fold_in(base, r), p))(jnp.asarray(rids, jnp.uint32),
                                         jnp.asarray(poss, jnp.uint32))
    return key, jkeys


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
def test_threefry_keys_and_bits_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rids = np.concatenate([[0, 1, 2 ** 31 - 1],
                           rng.integers(0, 2 ** 31, size=61)])
    poss = np.concatenate([[0, 2 ** 31 - 1, 7], rng.integers(0, 2 ** 20,
                                                             size=61)])
    key, jkeys = _keys(seed, rids, poss)
    jk = np.asarray(jkeys).astype(np.int64)
    assert np.array_equal(torch.stack(key, 1).numpy(), jk)
    bits = prng.random_bits(key, 1000).numpy()
    jbits = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (1000,), jnp.uint32))(jkeys)).astype(np.int64)
    assert np.array_equal(bits, jbits)


def test_uniform_bitwise_and_gumbel_within_ulps():
    """Uniform draws are bitwise jax's; Gumbel rows, -log(-log u), differ
    where the two frameworks' ``log`` rounds differently: within 8 ulp of
    1 (about 1e-6) absolute, ample for |g| <= 17."""
    rng = np.random.default_rng(3)
    rids = rng.integers(0, 2 ** 31, size=16)
    poss = rng.integers(0, 4096, size=16)
    key, jkeys = _keys(7, rids, poss)
    tiny = float(np.finfo(np.float32).tiny)
    u = prng.uniform(key, 4096, minval=tiny).numpy()
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (4096,), jnp.float32, minval=tiny, maxval=1.0))(jkeys))
    assert np.array_equal(u.view(np.int32), ju.view(np.int32))
    g = prng.gumbel_rows(7, _t(rids), _t(poss), 4096).numpy()
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (4096,), jnp.float32))(jkeys))
    np.testing.assert_allclose(g, jg, rtol=0, atol=8 * F32_EPS)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0),
                                               (0.8, 50)])
def test_sample_device_equals_jax(temperature, top_k):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    B, V = 64, 2000
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    rids = rng.integers(0, 2 ** 31, size=B).astype(np.int32)
    poss = rng.integers(0, 4096, size=B).astype(np.int32)
    want = JSampler(temperature, top_k, 5).sample_device(
        jnp.asarray(logits), jnp.asarray(rids), jnp.asarray(poss))
    got = Sampler(temperature, top_k, 5).sample_device(
        _t(logits), _t(rids), _t(poss))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_verify_device_equals_jax(temperature):
    """Lane 0 drafts what the target samples (all accepted), lane 1 misses
    its first draft, lane 2's padded rows past its width hold tokens equal
    to their targets and must not count, lane 3 is a width-1 window."""
    rng = np.random.default_rng(9)
    B, W, V = 4, 4, 64
    logits = (rng.normal(size=(B, W, V)) * 4).astype(np.float32)
    rids = np.arange(1, B + 1, dtype=np.int32)
    pos0 = np.array([10, 3, 17, 0], np.int32)
    widths = np.array([4, 3, 2, 1], np.int32)
    s = JSampler(temperature, 0, 1)
    # the targets, then windows built from them
    tg0, _ = s.verify_device(jnp.asarray(logits), jnp.zeros((B, W),
                                                            jnp.int32),
                             jnp.asarray(rids), jnp.asarray(pos0),
                             jnp.full((B,), W, jnp.int32))
    tg0 = np.asarray(tg0)
    inputs = np.zeros((B, W), np.int32)
    inputs[:, 1:] = tg0[:, :-1]
    inputs[1, 1] = (tg0[1, 0] + 1) % V
    args = (logits, inputs, rids, pos0, widths)
    jt, je = s.verify_device(*(jnp.asarray(a) for a in args))
    tt, te = Sampler(temperature, 0, 1).verify_device(*(_t(a) for a in args))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert te.tolist() == [4, 1, 2, 1]


# ---------------------------------------------------------------------------
# verify attention: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,W,H,KV,D,page,n_max,seed,pos0s", [
    (3, 4, 4, 2, 8, 4, 4, 0, None),     # GQA, windows crossing page edges
    (2, 3, 4, 1, 16, 8, 2, 1, None),    # MQA
    (2, 5, 2, 2, 8, 4, 3, 2, None),     # MHA, window up to 5
    (3, 1, 4, 2, 8, 4, 3, 3, None),     # W = 1
    (2, 9, 4, 2, 8, 4, 4, 4, None),     # W = 9, the deepest window
    (2, 5, 16, 2, 8, 4, 4, 5, [2, 6]),  # G = 8, windows across page edges
])
def test_fused_verify_plain_matches_pallas(B, W, H, KV, D, page, n_max,
                                           seed, pos0s):
    """Live rows' outputs agree at f32 1e-5; pools are equal off the scrap
    page (the Pallas kernel parks its write-backs there, and rows past a
    lane's width write only there).  ``pos0s`` fixes row 0's slot per lane
    (default: drawn so that the window fits the table)."""
    rng = np.random.default_rng(seed)
    P = B * n_max + 1
    f = np.float32
    q = rng.normal(size=(B, W, H, D)).astype(f)
    kn = rng.normal(size=(B, W, KV, D)).astype(f)
    vn = rng.normal(size=(B, W, KV, D)).astype(f)
    kp = rng.normal(size=(P, page, KV, D)).astype(f)
    vp = rng.normal(size=(P, page, KV, D)).astype(f)
    tables = rng.permutation(P - 1).reshape(B, n_max).astype(np.int32)
    widths = rng.integers(1, W + 1, size=B).astype(np.int32)
    widths[0] = W
    if pos0s is None:
        pos0 = np.array([rng.integers(0, n_max * page - w + 1)
                         for w in widths], np.int32)
    else:
        pos0 = np.array(pos0s, np.int32)
        assert all(p + w <= n_max * page for p, w in zip(pos0, widths))
    args = (q, kn, vn, kp, vp, tables, pos0, widths)
    oj, kj, vj = j_verify(*(jnp.asarray(a) for a in args), interpret=True)
    ot, kt, vt = tpa.fused_verify_attention(*(_t(a) for a in args))
    assert tpa.launches["fused_verify_attention"] == 0
    live = np.arange(W)[None, :] < widths[:, None]
    np.testing.assert_allclose(ot.numpy()[live], np.asarray(oj)[live],
                               rtol=0, atol=1e-5)
    assert np.array_equal(kt.numpy()[:-1], np.asarray(kj)[:-1])
    assert np.array_equal(vt.numpy()[:-1], np.asarray(vj)[:-1])
    # the CPU wrapper IS the plain version
    ref = tpa.fused_verify_attention_ref(*(_t(a) for a in args))
    assert torch.equal(ref[0], ot)


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("elem", [2, 4])
def test_verify_blocking_fits_and_covers_every_row(D, elem):
    """The kernels' blocking, for every window the wrapper admits (W up to
    9, speculation depth 8) and every group size from MHA to MQA at 32
    heads: shared memory within a block's limit and as the formula says,
    and the task groups of a (lane, kv-head) cover each (row, head) task
    once, none of them empty."""
    for W in range(1, 10):
        for G in (1, 2, 3, 4, 6, 8, 16, 32):
            per, groups, _, smem, _ = tpa.blocking(W, G, D, elem, 16, 16)
            assert smem == tpa.verify_smem_bytes(per, D, elem)
            assert smem <= tpa.MAX_SMEM
            tasks = [range(z * per, min((z + 1) * per, W * G))
                     for z in range(groups)]
            assert all(len(t) > 0 for t in tasks)
            covered = sorted(i for t in tasks for i in t)
            assert covered == list(range(W * G))
            assert {i // G for i in covered} == set(range(W))
    # the serving call: G = 8, so each window row runs in a group of its own
    assert tpa.blocking(5, 8, 64, 2, 16, 16)[:2] == (8, 5)


def test_verify_blocking_refuses_what_does_not_fit():
    """A head dim whose two ring stages alone exceed a block's shared
    memory raises instead of launching."""
    with pytest.raises(ValueError, match="shared memory"):
        tpa.blocking(5, 8, 512, 4, 16, 16)


BAD_VERIFY = {
    "int64 widths": dict(widths=torch.ones(2, dtype=torch.int64)),
    "widths shape": dict(widths=torch.ones(3, dtype=torch.int32)),
    "q without window": dict(q=torch.zeros(2, 4, 8)),
    "new rows without window": dict(k_new=torch.zeros(2, 2, 8)),
    "window mismatch": dict(v_new=torch.zeros(2, 2, 2, 8)),
}


@pytest.mark.parametrize("bad", sorted(BAD_VERIFY))
def test_verify_wrapper_validates_before_dispatch(bad):
    a = dict(q=torch.zeros(2, 3, 4, 8), k_new=torch.zeros(2, 3, 2, 8),
             v_new=torch.zeros(2, 3, 2, 8), k_pages=torch.zeros(5, 4, 2, 8),
             v_pages=torch.zeros(5, 4, 2, 8),
             tables=torch.zeros(2, 2, dtype=torch.int32),
             pos0=torch.zeros(2, dtype=torch.int32),
             widths=torch.ones(2, dtype=torch.int32))
    a.update(BAD_VERIFY[bad])
    with pytest.raises(ValueError):
        tpa.fused_verify_attention(*a.values())


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------
PAGE, N_MAX, POOL = 8, 4, 13          # pages 0..11 live, 12 is the scrap page


def _prefilled(prefill, pages, lens, rng, V):
    """Prefill one prompt per lane (lane b on pages 4b..4b+3) in one
    32-row chunk."""
    tables = np.arange(len(lens) * N_MAX, dtype=np.int32).reshape(-1, N_MAX)
    for b, L in enumerate(lens):
        toks = np.zeros((1, PAGE * N_MAX), np.int32)
        toks[0, :L] = rng.integers(0, V, size=L)
        pages = prefill(pages, toks, tables[b], L)
    return pages, tables


def test_verify_paged_matches_reference():
    """Model.verify_paged against the reference's on the same weights and
    pools: live rows' logits within f32 1e-4 (projection sums and rope
    round differently across frameworks, as for decode), pools within
    1e-6 off the scrap page."""
    jm = j_build(j_reduced(ARCH))
    tm = build_model(reduced_config(ARCH))
    jp = jax.tree.map(jnp.asarray, _jax_weights())
    tp = params_from_numpy(_jax_weights(), "cpu")
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(21)
    lens = [5, 12, 20]
    jpages = jm.init_paged_caches(POOL, PAGE)
    tpages = pages_from_numpy(jax.tree.map(np.asarray, jpages), "cpu")
    j_prefill = jax.jit(jm.prefill_paged)
    jpages, tables = _prefilled(
        lambda pg, t, tab, n: j_prefill(
            jp, pg, jnp.asarray(t), jnp.int32(0), jnp.asarray(tab),
            jnp.int32(n)), jpages, lens, np.random.default_rng(21), V)
    tpages, _ = _prefilled(
        lambda pg, t, tab, n: tm.prefill_paged(tp, pg, _t(t), 0, _t(tab), n),
        tpages, lens, rng, V)
    toks = np.random.default_rng(22).integers(0, V, size=(3, 4)).astype(
        np.int32)
    pos0 = np.asarray(lens, np.int32) - 1
    widths = np.array([4, 1, 3], np.int32)
    j_verify_paged = jax.jit(functools.partial(jm.verify_paged,
                                               interpret=True))
    lj, jpages = j_verify_paged(jp, jpages, jnp.asarray(toks),
                                jnp.asarray(pos0), jnp.asarray(widths),
                                jnp.asarray(tables))
    lt, tpages = tm.verify_paged(tp, tpages, _t(toks), _t(pos0), _t(widths),
                                 _t(tables))
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (3, 4, V)
    live = np.arange(4)[None, :] < widths[:, None]
    np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                               rtol=0, atol=1e-4)

    def check(t, j):
        np.testing.assert_allclose(t.numpy()[..., :POOL - 1, :, :, :],
                                   np.asarray(j)[..., :POOL - 1, :, :, :],
                                   rtol=0, atol=1e-6)
    tree_map(check, tpages, jpages)


@pytest.mark.parametrize("packed", [False, True])
def test_verify_rows_bitwise_equal_decode_rows(packed):
    """Each live verify row's logits are bitwise the port's decode_paged
    logits for the same token at the same position and batch width, and
    the pools end equal off the scrap page where the decode steps wrote the
    same rows.  Rows run as W slabs of the three lanes' row s, or packed
    (``verify_slabs``): the 11 live rows in four 3-row slabs, dead rows
    not computed (logits 0)."""
    tm = build_model(reduced_config(ARCH))
    tp = params_from_numpy(_jax_weights(), "cpu")
    V = tm.cfg.vocab_size
    lens, W = [3, 9, 16], 5
    widths = np.array([5, 2, 4], np.int32)

    def fresh():
        pages = tm.init_paged_caches(POOL, PAGE, "cpu")
        return _prefilled(lambda pg, t, tab, n: tm.prefill_paged(
            tp, pg, _t(t), 0, _t(tab), n), pages, lens,
            np.random.default_rng(5), V)

    toks = _t(np.random.default_rng(6).integers(0, V, size=(3, W)).astype(
        np.int32))
    pos0 = _t(np.asarray(lens, np.int32) - 1)
    pages, tables = fresh()
    rows = torch.from_numpy(verify_slabs(widths, W, 3)) if packed else None
    lv, pv = tm.verify_paged(tp, pages, toks, pos0, _t(widths), _t(tables),
                             rows)
    pages, _ = fresh()
    scrap = torch.full((3, N_MAX), POOL - 1, dtype=torch.int32)
    for s in range(W):
        tab_s = torch.where(_t(widths)[:, None] > s, _t(tables), scrap)
        ld, pages = tm.decode_paged(tp, pages, toks[:, s:s + 1], pos0 + s,
                                    tab_s, fused=True)
        for b in range(3):
            if s < widths[b]:
                assert torch.equal(lv[b, s], ld[b]), (b, s)
            elif packed:
                assert not lv[b, s].any(), (b, s)
    tree_map(lambda a, b: torch.equal(a[..., :POOL - 1, :, :, :],
                                      b[..., :POOL - 1, :, :, :]) or
             pytest.fail("pools differ"), pv, pages)


# ---------------------------------------------------------------------------
# the backend: spec-on streams equal spec-off (ports of test_spec_decode.py)
# ---------------------------------------------------------------------------
def _backend(**kw):
    kw.setdefault("num_blocks", 24)
    be = PagedTorchBackend(page=16, max_len=64, seed=0, device="cpu", **kw)
    be.params = params_from_numpy(_jax_weights(), "cpu")
    return be


def _streams(depth, decode_steps=1, **be_kw):
    be = _backend(**be_kw)
    eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                      EngineConfig(max_batch=2, prefill_budget=16,
                                   spec_depth_max=depth,
                                   decode_steps=decode_steps))
    eng.load([Request(rid=i + 1, app="chatbot", arrival=0.0,
                      prompt_len=20 + 3 * i, true_output_len=12,
                      slo=SLOSpec("throughput", ttlt=1e6))
              for i in range(2)], [])
    fin = eng.run()
    assert len(fin) == 2
    return {r.rid: list(be.generated[r.rid]) for r in fin}, eng


@pytest.mark.parametrize("depth,decode_steps", [(1, 1), (4, 1), (8, 1),
                                                (4, 4)])
def test_spec_streams_byte_identical_to_plain_decode(depth, decode_steps):
    ref, _ = _streams(0)
    got, eng = _streams(depth, decode_steps)
    assert got == ref
    assert eng.spec_proposed > 0 and eng.spec_accepted > 0
    assert eng.backend.n_verify_forwards > 0
    assert any(k[0] == "verify" for k in eng.backend._shapes)


def test_spec_accounting_consistent():
    _, eng = _streams(4)
    assert eng.spec_proposed >= eng.spec_accepted >= 0
    assert sum(len(t) for t in eng.backend.generated.values()) == 24
    assert eng.backend.n_decode_tokens == 24


def test_mixed_drafted_and_plain_lanes_partition():
    """A lane granted depth 0 rides the plain one-token call beside the
    drafted lanes' verify call; results keep lane order and every lane's
    emitted tokens are the plain-decode reference's.  Lanes 0 and 2 repeat
    a motif in their prompts, so the drafter proposes from the first
    step."""
    be, twin = _backend(), _backend()
    motif = [11, 42, 7, 99]
    reqs = [Request(rid=i + 1, app="chatbot", arrival=0.0,
                    prompt_len=18 + i, true_output_len=8,
                    slo=SLOSpec("throughput", ttlt=1e6))
            for i in range(3)]
    for i in (0, 2):
        reqs[i].meta["prompt_tokens"] = (motif * 5)[:reqs[i].prompt_len]
    bm = BlockManager(num_blocks=be.num_blocks,
                      block_tokens=be.block_tokens)
    tabs = {}
    for r in reqs:
        assert bm.ensure(r.rid, r.prompt_len + 4)
        tabs[r.rid] = bm.block_table(r.rid)
        for b in (be, twin):
            b.prefill_chunk(r, 0, r.prompt_len, tabs[r.rid])
    for _ in range(4):                   # the reference: plain decode
        twin.decode_batch(reqs, [tabs[r.rid] for r in reqs])
        for r in reqs:
            r.decoded += 1
    for r in reqs:
        r.decoded = 0
    res = be.decode_verify_batch(reqs, [tabs[r.rid] for r in reqs],
                                 [3, 0, 3])
    assert res[1] == (1, 0, 0), "a depth-0 lane must be a plain decode row"
    assert res[0][2] == res[2][2] == 3
    for r, (e, a, p) in zip(reqs, res):
        assert 1 <= e <= 4 and a == e - 1 and p <= 3
        assert be.generated[r.rid] == twin.generated[r.rid][:e]
        r.decoded += e
        bm.truncate(r.rid, r.prompt_len + r.decoded)
        bm.check_invariants()


def test_null_drafter_degrades_to_plain_decode():
    ref, _ = _streams(0)
    got, eng = _streams(4, drafter=NullDrafter())
    assert got == ref
    assert eng.spec_proposed == 0 and eng.spec_accepted == 0
    assert eng.backend.n_verify_forwards == 0


# ---------------------------------------------------------------------------
# cross-framework: PagedJaxBackend vs PagedTorchBackend, speculation on
# ---------------------------------------------------------------------------
def _digest(be) -> str:
    streams = sorted((rid, tuple(t)) for rid, t in be.generated.items())
    return hashlib.sha256(repr(streams).encode()).hexdigest()[:16]


def _requests(Request, SLOSpec):
    """Staggered arrivals, mixed SLO kinds; two prompts repeat a short
    motif, so the n-gram drafter has matches at any temperature.  The
    first motif request is best-effort (kind "none"): gmg grants such
    lanes a fixed depth, where SLO lanes' depths follow the margin, and so
    the measured step times."""
    motif = [11, 42, 7, 99]
    spec = [(0.00, 20, 8, "latency", None), (0.02, 12, 6, "none",
                                             motif * 3),
            (0.04, 30, 6, "throughput", None), (0.06, 16, 7, "latency",
                                                motif * 4)]
    reqs = []
    for i, (t, prompt, out, kind, toks) in enumerate(spec):
        r = Request(rid=i + 1, app="chatbot", arrival=t, prompt_len=prompt,
                    true_output_len=out,
                    slo=SLOSpec(kind, ttft=5.0, tbt=1.0, ttlt=60.0))
        if toks is not None:
            r.meta["prompt_tokens"] = list(toks)
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("scheduler,temperature", [
    ("vllm", 0.0), ("gmg", 0.0), ("vllm", 0.8), ("gmg", 0.8)])
def test_spec_stream_digest_matches_jax_backend(scheduler, temperature):
    from repro.core.baselines import make_scheduler as j_make_scheduler
    from repro.serving.engine import (EngineConfig as JEngineConfig,
                                      ServeEngine as JServeEngine)
    from repro.serving.jax_backend import PagedJaxBackend
    from repro.serving.request import Request as JRequest, SLOSpec as JSLO

    kw = dict(use_predictor=False) if scheduler == "gmg" else {}
    geo = dict(num_blocks=32, page=16, max_len=64, seed=0,
               temperature=temperature, top_k=50 if temperature else 0)
    cfg = dict(max_batch=4, prefill_budget=16, spec_depth_max=4)
    bj = PagedJaxBackend(**geo)
    ej = JServeEngine(bj, j_make_scheduler(scheduler, **kw),
                      JEngineConfig(**cfg))
    ej.load(_requests(JRequest, JSLO), [])
    fj = ej.run()
    bt = PagedTorchBackend(device="cpu", **geo)
    bt.params = params_from_numpy(jax.tree.map(np.asarray, bj.params), "cpu")
    et = ServeEngine(bt, make_scheduler(scheduler, **kw),
                     EngineConfig(**cfg))
    et.load(_requests(Request, SLOSpec), [])
    ft = et.run()
    assert len(ft) == len(fj) == 4
    assert sum(len(t) for t in bt.generated.values()) == 8 + 6 + 6 + 7
    assert _digest(bt) == _digest(bj)
    # which steps speculate follows the measured step times, so the two
    # engines' proposal counts may differ; both must have speculated
    assert et.spec_proposed > 0 and ej.spec_proposed > 0
