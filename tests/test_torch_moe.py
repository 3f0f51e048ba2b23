"""The port's MoE (repro_torch.models.moe) and the models that use it
against the JAX package, on the CPU: ``moe_dense`` / ``moe_apply`` at
reduced widths (f32, atol 1e-5: the two frameworks sum the combine in
other orders), ties in the router's top-k, the reduced kimi-k2 (attn +
moe) and deepseek-v2-lite (mla + moe) full-sequence forwards with the JAX
weights carried across by ``params_from_numpy`` (logits 1e-4, as
``tests/test_torch_fullseq.py``), kimi's paged path (pools 1e-6, logits
1e-4, as ``tests/test_torch_model.py``), ``PagedTorchBackend`` serving
kimi with the streams of ``PagedJaxBackend``, a port of
``tests/test_models_smoke.py`` over every reduced architecture (the
forward's logits, then ``Model.loss`` and every gradient against
``jax.value_and_grad``; also at minitron's head dim 128 and deepseek's MLA
qk 128 + 64, v 128), and the flash plain version at deepseek's head dims (192, 128) against
the Pallas kernel in interpret mode."""

import dataclasses
import functools
import hashlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.models.attention import \
    causal_attention as j_causal  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.models.moe import _route as j_route  # noqa: E402
from repro.models.moe import moe_apply as j_moe_apply  # noqa: E402
from repro.models.moe import moe_dense as j_moe_dense  # noqa: E402
from repro.models.partition import NULL_CTX, AxisCtx  # noqa: E402
from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import (pages_from_numpy,  # noqa: E402
                                        params_from_numpy, tree_leaves,
                                        tree_map)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402

KIMI, DEEPSEEK = "kimi-k2-1t-a32b", "deepseek-v2-lite-16b"
MOE_ATOL = 1e-5
LOGITS_ATOL = 1e-4
POOL_ATOL = 1e-6
# the architectures the port runs, and those it refuses (mamba, xLSTM, the
# audio and vision frontends)
RUNS = [KIMI, DEEPSEEK, "tinyllama-1.1b", "minicpm3-4b", "yi-34b",
        "minitron-4b"]
REFUSED = ["jamba-v0.1-52b", "xlstm-1.3b", "musicgen-medium", "pixtral-12b"]
B, S = 2, 12


def _cfg(shared, top_k=2, E=6):
    return ModelConfig(name="moe-test", family="moe", num_layers=1,
                       d_model=32, num_heads=4, num_kv_heads=2, d_ff=0,
                       vocab_size=64, unit_pattern=(("attn", "moe"),),
                       num_experts=E, top_k=top_k, d_ff_expert=16,
                       num_shared_experts=shared, dtype="float32")


def _moe_params(cfg, seed):
    """Seeded numpy weights in the reference's layout, std 0.2 so the
    router's choices are well apart."""
    rng = np.random.default_rng(seed)
    d, E, F = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    shapes = dict(router=(d, E), w_gate=(E, d, F), w_up=(E, d, F),
                  w_down=(E, F, d))
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * F
        shapes.update(shared_gate=(d, fs), shared_up=(d, fs),
                      shared_down=(fs, d))
    return {k: (rng.normal(size=s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("shared", [0, 1, 2])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_matches_reference(shared, top_k):
    cfg = _cfg(shared, top_k)
    p = _moe_params(cfg, 10 * shared + top_k)
    x = np.random.default_rng(7).normal(size=(3, 5, cfg.d_model)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, "cpu")
    tx = torch.from_numpy(x)
    dense = moe.moe_dense(tx, tp, cfg)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(j_moe_dense(jnp.asarray(x), jp, cfg)),
        rtol=0, atol=MOE_ATOL)
    out = moe.moe_apply(tx, tp, cfg)
    assert out.shape == tx.shape and out.dtype == tx.dtype
    np.testing.assert_allclose(
        out.numpy(), np.asarray(j_moe_apply(jnp.asarray(x), jp, cfg,
                                            NULL_CTX)),
        rtol=0, atol=MOE_ATOL)
    # the routes themselves: same experts in the same order, same weights
    tv, ti = moe._route(tx.reshape(-1, cfg.d_model), tp["router"], top_k)
    jv, ji = j_route(jnp.asarray(x.reshape(-1, cfg.d_model)), jp["router"],
                     top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6)


def test_router_ties_take_the_lower_expert_first():
    """Experts 1, 3 and 4 have equal router columns, the largest: top-3 is
    [1, 3, 4] in that order, as ``lax.top_k`` gives, and top-2 cuts 4."""
    cfg = _cfg(0, top_k=3)
    d, E = cfg.d_model, cfg.num_experts
    x = np.abs(np.random.default_rng(3).normal(size=(4, d))).astype(
        np.float32)
    router = np.zeros((d, E), np.float32)
    router[:, [1, 3, 4]] = 0.5
    router[:, 0] = 0.1
    for k, want in ((3, [1, 3, 4]), (2, [1, 3])):
        tv, ti = moe._route(torch.from_numpy(x), torch.from_numpy(router), k)
        _, ji = j_route(jnp.asarray(x), jnp.asarray(router), k)
        assert ti.tolist() == [want] * 4
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), 1.0 / k, rtol=0, atol=1e-6)


def test_moe_bf16_matches_reference():
    """bf16 weights and activations: the router in f32 on both sides, so
    the same experts are chosen; the expert products in bf16, rounded at
    other places by the two frameworks.  The output adds two bf16 terms,
    routed and shared experts, which may cancel: each may be off by two
    bf16 ulps (2^-7 relative) at its largest size."""
    cfg = dataclasses.replace(_cfg(1), dtype="bfloat16")
    p = _moe_params(cfg, 5)
    x = np.random.default_rng(8).normal(size=(2, 6, cfg.d_model))
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    _, ti = moe._route(tx.reshape(-1, cfg.d_model), tp["router"], 2)
    _, ji = j_route(jx.reshape(-1, cfg.d_model), jp["router"], 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    out = moe.moe_apply(tx, tp, cfg)
    assert out.dtype == torch.bfloat16
    routed = np.asarray(j_moe_dense(jx, jp, cfg), np.float32)
    full = np.asarray(j_moe_apply(jx, jp, cfg, NULL_CTX), np.float32)
    tol = 2 * 2.0 ** -7 * (np.abs(routed).max() + np.abs(full - routed).max())
    np.testing.assert_allclose(out.float().numpy(), full, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# reduced kimi-k2 and deepseek-v2-lite: the full-sequence forward
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def _jax_weights(arch):
    jm = j_build(j_reduced(arch))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", params=[KIMI, DEEPSEEK])
def models(request):
    jm = j_build(j_reduced(request.param))
    tm = build_model(reduced_config(request.param))
    jp = jax.tree.map(jnp.asarray, _jax_weights(request.param))
    tp = params_from_numpy(_jax_weights(request.param), "cpu")
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jp, tm, tp, toks


def _grown(tm, caches, length):
    out = tm.init_caches(B, length, "cpu")
    tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)].copy_(c),
             out, caches)
    return out


def _j_grown(jm, caches, length):
    def grow(z, c):
        return z.at[tuple(slice(0, n) for n in c.shape)].set(c)
    return jax.tree.map(grow, jm.init_caches(B, length), caches)


def test_init_layout_matches_reference(models):
    """The port's own init draws the reference's tree: same keys, shapes
    and dtype, the MoE leaves among them."""
    jm, jp, tm, _, _ = models
    assert tm.cfg == reduced_config(jm.cfg.name.removesuffix("-smoke"))
    assert tm.cfg.num_experts and any(f == "moe"
                                      for _, f in tm.cfg.unit_pattern)
    mine = tm.init(torch.Generator().manual_seed(0))
    assert len(tree_leaves(mine)) == len(jax.tree.leaves(jp))

    def same(t, j):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    tree_map(same, mine, jp)
    assert set(mine["units"]["l0"]) >= {"router", "w_gate", "w_up",
                                        "w_down"}


def test_logits_prefill_decode_match_reference(models):
    jm, jp, tm, tp, toks = models
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    full = tm.logits(tp, {"tokens": tt})
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jm.logits(jp, {"tokens": jt, "labels": jt})),
        rtol=0, atol=LOGITS_ATOL)
    lj, cj = jm.prefill(jp, {"tokens": jt[:, :S - 1]})
    lt, ct = tm.prefill(tp, {"tokens": tt[:, :S - 1]})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGITS_ATOL)
    cj, ct = _j_grown(jm, cj, S), _grown(tm, ct, S)
    dj, _ = jm.decode_step(jp, cj, jt[:, S - 1:], jnp.int32(S - 1))
    dt, _ = tm.decode_step(tp, ct, tt[:, S - 1:], S - 1)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=LOGITS_ATOL)


def test_prefill_decode_matches_teacher_forcing(models):
    """The reference's contract (``tests/test_models_smoke.py``):
    ``decode_step`` at S-1 after ``prefill`` of S-1 tokens gives the
    full-sequence logits at S-1, within 2e-2."""
    _, _, tm, tp, toks = models
    tt = torch.from_numpy(toks)
    full = tm.logits(tp, {"tokens": tt})
    _, caches = tm.prefill(tp, {"tokens": tt[:, :S - 1]})
    logits, _ = tm.decode_step(tp, _grown(tm, caches, S), tt[:, S - 1:],
                               torch.tensor(S - 1))
    np.testing.assert_allclose(logits.numpy(), full[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# reduced kimi-k2: the paged path against the JAX package's
# ---------------------------------------------------------------------------
PAGE, N_MAX = 8, 4
POOL = 12                       # pages 0..10 live, 11 is the scrap page


def _pools_match(tpages, jpages):
    def check(t, j):
        np.testing.assert_allclose(t.numpy()[..., :POOL - 1, :, :, :],
                                   np.asarray(j)[..., :POOL - 1, :, :, :],
                                   rtol=0, atol=POOL_ATOL)
    tree_map(check, tpages, jpages)


@pytest.mark.parametrize("fused", [True, False])
def test_kimi_paged_prefill_decode_verify_match_reference(fused):
    """Chunked prefill of three prompts (chunks 5, 9, 16 padded to 16
    rows), three batched decode steps, then a verify window (widths 4, 1,
    3): pools within 1e-6 off the scrap page, logits within 1e-4."""
    jm = j_build(j_reduced(KIMI))
    tm = build_model(reduced_config(KIMI))
    assert tm.supports_paged() and jm.supports_paged()
    jp = jax.tree.map(jnp.asarray, _jax_weights(KIMI))
    tp = params_from_numpy(_jax_weights(KIMI), "cpu")
    rng = np.random.default_rng(11)
    V = tm.cfg.vocab_size
    jpages = jm.init_paged_caches(POOL, PAGE)
    tpages = pages_from_numpy(jax.tree.map(np.asarray, jpages), "cpu")
    j_prefill = jax.jit(jm.prefill_paged)
    j_decode = jax.jit(functools.partial(jm.decode_paged, interpret=True,
                                         fused=fused))
    tables = np.asarray([[3, 1, 7, 0], [2, 5, 11, 11], [9, 4, 6, 10]],
                        np.int32)
    lens = [15, 9, 20]
    for b, L in enumerate(lens):
        prompt = rng.integers(0, V, size=L).astype(np.int32)
        start = 0
        for n in (5, 9, 16):
            n = min(n, L - start)
            if n <= 0:
                break
            toks = np.zeros((1, 16), np.int32)
            toks[0, :n] = prompt[start:start + n]
            jpages = j_prefill(jp, jpages, jnp.asarray(toks),
                               jnp.int32(start), jnp.asarray(tables[b]),
                               jnp.int32(n))
            tpages = tm.prefill_paged(tp, tpages, torch.tensor(toks), start,
                                      torch.tensor(tables[b]), n)
            start += n
    _pools_match(tpages, jpages)
    pos = np.asarray(lens, np.int32) - 1
    toks = rng.integers(0, V, size=(3, 1)).astype(np.int32)
    for _ in range(3):
        lj, jpages = j_decode(jp, jpages, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(tables))
        lt, tpages = tm.decode_paged(tp, tpages, torch.tensor(toks),
                                     torch.tensor(pos), torch.tensor(tables),
                                     fused=fused)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGITS_ATOL)
        _pools_match(tpages, jpages)
        toks = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)[:, None]
        pos = pos + 1
    # a verify window: row 0 at the next write slot, then drafts
    W = 4
    wtoks = np.concatenate([toks, rng.integers(0, V, size=(3, W - 1))],
                           axis=1).astype(np.int32)
    widths = np.array([4, 1, 3], np.int32)
    j_verify = jax.jit(functools.partial(jm.verify_paged, interpret=True))
    lj, jpages = j_verify(jp, jpages, jnp.asarray(wtoks), jnp.asarray(pos),
                          jnp.asarray(widths), jnp.asarray(tables))
    lt, tpages = tm.verify_paged(tp, tpages, torch.tensor(wtoks),
                                 torch.tensor(pos), torch.tensor(widths),
                                 torch.tensor(tables))
    live = np.arange(W)[None, :] < widths[:, None]
    np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                               rtol=0, atol=LOGITS_ATOL)
    _pools_match(tpages, jpages)


# ---------------------------------------------------------------------------
# reduced kimi-k2 behind PagedTorchBackend
# ---------------------------------------------------------------------------
MOTIF = [11, 42, 7, 99]


def _requests(Request, SLOSpec):
    """Staggered arrivals, mixed SLO kinds, prompts across page edges; two
    repeat a motif, so the n-gram drafter has matches."""
    spec = [(0.00, 20, 8, "latency", None),
            (0.02, 12, 6, "throughput", MOTIF * 3),
            (0.04, 30, 6, "throughput", None),
            (0.06, 16, 7, "latency", MOTIF * 4)]
    reqs = []
    for i, (t, prompt, out, kind, toks) in enumerate(spec):
        r = Request(rid=i + 1, app="chatbot", arrival=t, prompt_len=prompt,
                    true_output_len=out,
                    slo=SLOSpec(kind, ttft=5.0, tbt=1.0, ttlt=60.0))
        if toks is not None:
            r.meta["prompt_tokens"] = list(toks)
        reqs.append(r)
    return reqs


def _digest(be) -> str:
    streams = sorted((rid, tuple(t)) for rid, t in be.generated.items())
    return hashlib.sha256(repr(streams).encode()).hexdigest()[:16]


GEO = dict(num_blocks=32, page=16, max_len=64, seed=0)


def _torch_run(scheduler, depth=0, drafter=None):
    kw = dict(use_predictor=False) if scheduler == "gmg" else {}
    be = PagedTorchBackend(arch=KIMI, device="cpu", drafter=drafter, **GEO)
    be.params = params_from_numpy(_jax_weights(KIMI), "cpu")
    eng = ServeEngine(be, make_scheduler(scheduler, **kw),
                      EngineConfig(max_batch=4, prefill_budget=16,
                                   spec_depth_max=depth))
    eng.load(_requests(Request, SLOSpec), [])
    assert len(eng.run()) == 4
    assert sum(len(t) for t in be.generated.values()) == 8 + 6 + 6 + 7
    return be, eng


@pytest.mark.parametrize("scheduler", ["vllm", "gmg"])
def test_kimi_stream_digest_matches_jax_backend(scheduler):
    from repro.core.baselines import make_scheduler as j_make_scheduler
    from repro.serving.engine import (EngineConfig as JEngineConfig,
                                      ServeEngine as JServeEngine)
    from repro.serving.jax_backend import PagedJaxBackend
    from repro.serving.request import Request as JRequest, SLOSpec as JSLO

    kw = dict(use_predictor=False) if scheduler == "gmg" else {}
    bj = PagedJaxBackend(arch=KIMI, **GEO)
    ej = JServeEngine(bj, j_make_scheduler(scheduler, **kw),
                      JEngineConfig(max_batch=4, prefill_budget=16))
    ej.load(_requests(JRequest, JSLO), [])
    assert len(ej.run()) == 4
    bt, _ = _torch_run(scheduler)
    assert bt.cfg.name == bj.cfg.name == "kimi-k2-1t-a32b-smoke"
    assert _digest(bt) == _digest(bj)


class _Replay:
    """Drafts a finished run's streams back, so drafts are accepted."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, tokens, k):
        hist = [int(t) for t in tokens]
        for s in self.streams:
            if len(s) > len(hist) and s[:len(hist)] == hist:
                return s[len(hist):len(hist) + k]
        return []


def test_kimi_spec_streams_equal_plain_decode():
    """Speculation on the MoE stack: spec 4 with n-gram drafts and with
    drafts replayed from the plain run (accepted, so accepted rows' KV is
    read by later steps) give the plain run's streams."""
    plain, _ = _torch_run("vllm")
    _, spec = _torch_run("vllm", depth=4)
    assert _digest(spec.backend) == _digest(plain)
    assert spec.spec_proposed > 0 and spec.backend.n_verify_forwards > 0
    streams = [[int(t) for t in plain.prompt_ids(r)]
               + list(plain.generated[r.rid])
               for r in _requests(Request, SLOSpec)]
    _, rep = _torch_run("vllm", depth=4, drafter=_Replay(streams))
    assert _digest(rep.backend) == _digest(plain)
    assert rep.spec_accepted > 0


# ---------------------------------------------------------------------------
# every reduced architecture (a port of tests/test_models_smoke.py's forward)
# ---------------------------------------------------------------------------
def test_arch_lists_partition_the_registry():
    assert sorted(RUNS + REFUSED) == sorted(list_archs())


@pytest.mark.parametrize("arch", RUNS)
def test_smoke_forward_matches_reference(arch):
    cfg = reduced_config(arch)
    jm = j_build(j_reduced(arch))
    tm = build_model(cfg)
    tp = params_from_numpy(_jax_weights(arch), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 16)).astype(np.int32)
    lt = tm.logits(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(lt.shape) == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(lt).all())
    jt = jnp.asarray(toks)
    lj = jm.logits(jax.tree.map(jnp.asarray, _jax_weights(arch)),
                   {"tokens": jt, "labels": jt})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGITS_ATOL)
    # the port's own init of the same tree runs too
    own = tm.init(torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(
        tm.logits(own, {"tokens": torch.from_numpy(toks)})).all())


@pytest.mark.parametrize("arch", RUNS)
def test_smoke_loss_and_grads_match_reference(arch):
    """The train half of ``tests/test_models_smoke.py``: ``Model.loss`` and
    every gradient leaf against ``jax.value_and_grad(model.loss)`` on the
    same weights and batch; loss within 1e-5, gradients within 1e-6 (f32
    reductions in other orders: they measure at most 4.8e-7 and 5.4e-8,
    for gradients up to 0.12), all finite, the gradient norm above 0."""
    cfg = reduced_config(arch)
    jm, tm = j_build(j_reduced(arch)), build_model(cfg)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jl, jg = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, _jax_weights(arch)),
        jax.tree.map(jnp.asarray, batch))
    tl, tg = value_and_grad(tm.loss, params_from_numpy(_jax_weights(arch),
                                                       "cpu"),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(tl)) and abs(float(tl) - float(jl)) < 1e-5
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=0, atol=1e-6), tg, jg)
    gnorm = sum(float(g.square().sum()) for g in tree_leaves(tg))
    assert np.isfinite(gnorm) and gnorm > 0


# two narrow 2-layer configs at the full-width models' head dims, where the
# flash backward's (128, 128) and (192, 128) pairs run: minitron's GQA
# grouping (G = 3) at head dim 128, deepseek's MLA at qk 128 + 64, v 128
FULL_HEADS = {"minitron-4b": dict(num_layers=2, num_heads=6, num_kv_heads=2,
                                  head_dim=128),
              DEEPSEEK: dict(qk_nope_dim=128, qk_rope_dim=64,
                             v_head_dim=128)}


@pytest.mark.parametrize("arch", sorted(FULL_HEADS))
def test_loss_and_grads_at_full_head_dims_match_reference(arch):
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad(model.loss)`` on the JAX package's weights, at
    ``test_smoke_loss_and_grads_match_reference``'s tolerances; the
    attention's gradient goes through ``FlashAttentionFn`` at the new
    head-dim pair."""
    cfg = dataclasses.replace(reduced_config(arch), **FULL_HEADS[arch])
    jm = j_build(dataclasses.replace(j_reduced(arch), **FULL_HEADS[arch]))
    tm = build_model(cfg)
    dims = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
            if cfg.kv_lora_rank else (128, 128))
    assert cfg.num_layers == 2 and dims in fa.BWD_HEAD_DIMS
    weights = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, weights),
                                         jax.tree.map(jnp.asarray, batch))
    tl, tg = value_and_grad(tm.loss, params_from_numpy(weights, "cpu"),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(tl)) and abs(float(tl) - float(jl)) < 1e-5
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=0, atol=1e-6), tg, jg)
    gnorm = sum(float(g.square().sum()) for g in tree_leaves(tg))
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("arch", REFUSED)
def test_unported_archs_raise(arch):
    """mamba and xLSTM mixers are refused at init, the audio and vision
    frontends at the forward; neither is served paged."""
    tm = build_model(reduced_config(arch))
    assert not tm.supports_paged()
    with pytest.raises(ValueError):
        params = tm.init(torch.Generator().manual_seed(0))
        tm.logits(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(ValueError):
        PagedTorchBackend(arch=arch, device="cpu")


# ---------------------------------------------------------------------------
# the flash kernel's plain version at deepseek's MLA prefill head dims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV", [(64, 2, 2), (128, 4, 1)])
def test_flash_plain_version_at_192_128_matches_pallas(S, H, KV, dtype,
                                                       causal):
    """The Pallas kernel takes one head dim for q, k and v: v is padded
    with zero columns to Dk = 192, and the first 128 output columns are
    the attention of v.  Tolerances of ``tests/test_torch_flash.py``
    (3e-5 f32, 2.5e-2 bf16)."""
    rng = np.random.default_rng(S + H)
    jt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(rng.normal(size=(2, S, h, D)), jt)
                  for h, D in ((H, 192), (KV, 192), (KV, 128)))
    q, k, v = (torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    assert (192, 128) in fa.HEAD_DIMS
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, causal=causal)
    assert out.shape == (2, S, H, 128) and out.dtype == q.dtype
    assert fa.launches == before
    jv_pad = jnp.pad(jv, ((0, 0), (0, 0), (0, 0), (0, 64)))
    kern = j_flash(jq, jk, jv_pad, causal=causal, block_q=64, block_k=64,
                   interpret=True)
    tol = 3e-5 if dtype == "float32" else 2.5e-2
    err = np.abs(out.float().numpy() - np.asarray(kern[..., :128],
                                                  np.float32)).max()
    assert err < tol
    assert not np.asarray(kern[..., 128:]).any()
    if causal:
        ref = j_causal(jq, jk, jv, AxisCtx(attn_schedule="rect",
                                           attn_chunk=32),
                       scale=192 ** -0.5)
        err = np.abs(out.float().numpy() - np.asarray(ref, np.float32)).max()
        assert err < tol
