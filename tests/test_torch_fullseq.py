"""The port's full-sequence forward (``Model.logits`` / ``prefill`` /
``decode_step``, ``launch.steps``) against the JAX package's, on the
reduced tinyllama (GQA) and minicpm3 (MLA) with the JAX weights carried
across by ``params_from_numpy``: logits within 1e-4 and caches within f32
rounding, the tolerances of ``tests/test_torch_model.py``; the port's own
teacher-forcing contract; greedy streams equal to the JAX package's; and,
on tinyllama, ``decode_step`` logits equal to the paged ``decode_paged``
logits of the same tokens."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tree_leaves, tree_map)
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["tinyllama-1.1b", "minicpm3-4b"]
B, S = 2, 12
LOGITS_ATOL = 1e-4
# caches: f32 rounding of the two frameworks' projections, norms and rope
# (the normed MLA latent reaches |x| ~ 4, where one f32 ulp is 4.8e-7)
CACHE_ATOL = CACHE_RTOL = 1e-6
# bf16 logits: the two frameworks round bf16 activations at other places;
# 1e-2 is about 4 bf16 ulps at |logit| < 1 (the reduced models' logits stay
# below 0.7, where the gap measures 1.5e-3 and 2.3e-3)
BF16_LOGITS_ATOL = 1e-2


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jm = j_build(j_reduced(request.param))
    tm = build_model(reduced_config(request.param))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jp, tm, tp, toks


def _grown(tm, caches, length):
    """``caches`` copied into zero caches of ``length`` positions."""
    out = tm.init_caches(B, length, "cpu")
    tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)].copy_(c),
             out, caches)
    return out


def _j_grown(jm, caches, length):
    def grow(z, c):
        return z.at[tuple(slice(0, n) for n in c.shape)].set(c)
    return jax.tree.map(grow, jm.init_caches(B, length), caches)


def test_init_and_cache_layout_match_reference(models):
    jm, jp, tm, _, _ = models
    assert tm.cfg == reduced_config(jm.cfg.name.removesuffix("-smoke"))
    mine = tm.init(torch.Generator().manual_seed(0))
    assert len(tree_leaves(mine)) == len(jax.tree.leaves(jp))

    def same(t, j):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    tree_map(same, mine, jp)
    js = jax.tree.leaves(jm.cache_specs(B, S))
    ts = tree_leaves(tm.cache_specs(B, S))
    assert [tuple(t.shape) for t in ts] == [s.shape for s in js]


def test_logits_prefill_decode_match_reference(models):
    jm, jp, tm, tp, toks = models
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    full = tm.logits(tp, {"tokens": tt})
    assert full.dtype == torch.float32
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jm.logits(jp, {"tokens": jt, "labels": jt})),
        rtol=0, atol=LOGITS_ATOL)
    lj, cj = jm.prefill(jp, {"tokens": jt[:, :S - 1]})
    lt, ct = tm.prefill(tp, {"tokens": tt[:, :S - 1]})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGITS_ATOL)
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=CACHE_RTOL, atol=CACHE_ATOL), ct, cj)
    # decode the last token against caches grown to S, on both sides
    cj, ct = _j_grown(jm, cj, S), _grown(tm, ct, S)
    dj, cj = jm.decode_step(jp, cj, jt[:, S - 1:], jnp.int32(S - 1))
    dt, ct2 = tm.decode_step(tp, ct, tt[:, S - 1:], S - 1)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=LOGITS_ATOL)
    assert all(a is b for a, b in zip(tree_leaves(ct2), tree_leaves(ct)))
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=CACHE_RTOL, atol=CACHE_ATOL), ct2, cj)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_reference(arch):
    """The serving dtype: the reduced model in bf16 with the JAX package's
    bf16 weights; logits within ``BF16_LOGITS_ATOL`` of the JAX model's,
    and the same argmax at every position."""
    jm = j_build(dataclasses.replace(j_reduced(arch), dtype="bfloat16"))
    tm = build_model(dataclasses.replace(reduced_config(arch),
                                         dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp)
               if t.is_floating_point() and t.dim() > 1)
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    jt = jnp.asarray(toks)
    lj = np.asarray(jm.logits(jp, {"tokens": jt, "labels": jt}), np.float32)
    lt = tm.logits(tp, {"tokens": torch.from_numpy(toks)}).float().numpy()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=BF16_LOGITS_ATOL)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))


def test_prefill_decode_matches_teacher_forcing(models):
    """The reference's contract (``tests/test_models_smoke.py``):
    ``decode_step`` at S-1 after ``prefill`` of S-1 tokens gives the
    full-sequence logits at S-1."""
    _, _, tm, tp, toks = models
    tt = torch.from_numpy(toks)
    full = tm.logits(tp, {"tokens": tt})
    _, caches = tm.prefill(tp, {"tokens": tt[:, :S - 1]})
    logits, _ = tm.decode_step(tp, _grown(tm, caches, S), tt[:, S - 1:],
                               torch.tensor(S - 1))
    np.testing.assert_allclose(logits.numpy(), full[:, S - 1].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_step_builders_greedy_streams_match_reference(models):
    """``make_prefill_step`` then ``make_serve_step``: four greedy tokens
    equal the JAX model's, with logits within 1e-4 at every step."""
    jm, jp, _, tp, toks = models
    steps = 4
    model, prefill_step = make_prefill_step(reduced_config(
        jm.cfg.name.removesuffix("-smoke")))
    _, serve_step = make_serve_step(model.cfg)
    lt, ct = prefill_step(tp, {"tokens": torch.from_numpy(toks)})
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    ct, cj = _grown(model, ct, S + steps), _j_grown(jm, cj, S + steps)
    for i in range(steps):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGITS_ATOL)
        nt = lt.argmax(-1).to(torch.int32)[:, None]
        nj = jnp.argmax(lj, axis=-1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        lt, ct = serve_step(tp, ct, nt, S + i)
        lj, cj = jm.decode_step(jp, cj, nj, jnp.int32(S + i))


def test_decode_step_matches_paged_decode():
    """tinyllama: the full-sequence path (``prefill`` + ``decode_step``)
    and the paged path (``prefill_paged`` per sequence + fused
    ``decode_paged``) give the same last-position logits."""
    cfg = reduced_config("tinyllama-1.1b")
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    _, caches = tm.prefill(tp, {"tokens": toks[:, :S - 1]})
    full, _ = tm.decode_step(tp, _grown(tm, caches, S), toks[:, S - 1:],
                             S - 1)
    page, n_max = 4, 3
    pages = tm.init_paged_caches(B * n_max + 1, page, "cpu")
    tables = torch.arange(B * n_max, dtype=torch.int32).view(B, n_max)
    for b in range(B):
        pages = tm.prefill_paged(tp, pages, toks[b:b + 1, :S - 1], 0,
                                 tables[b], S - 1)
    paged, _ = tm.decode_paged(tp, pages, toks[:, S - 1:].contiguous(),
                               torch.full((B,), S - 1, dtype=torch.int32),
                               tables, fused=True)
    np.testing.assert_allclose(full.numpy(), paged.numpy(), rtol=0,
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("pattern", [(("mamba", "mlp"),),
                                     (("mlstm", "none"),)])
def test_unported_layers_raise(pattern):
    """Recurrent layers run in the full-sequence forward (since they were
    ported) but have no paged state: the paged path refuses them, as the
    reference's ``layer_apply_paged`` does."""
    cfg = dataclasses.replace(reduced_config("tinyllama-1.1b"),
                              unit_pattern=pattern)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    assert tuple(m.logits(params, {"tokens": toks}).shape) == (
        1, 4, cfg.vocab_size)
    assert not m.supports_paged()
    pages = m.init_paged_caches(3, 4, "cpu")
    with pytest.raises(ValueError):
        m.prefill_paged(params, pages, toks, 0,
                        torch.zeros(2, dtype=torch.int32), 4)
