"""The port's paged model (repro_torch.models.model) against the JAX
package's, on the reduced tinyllama with the JAX weights carried across by
repro_torch.models.convert: chunked prefill then batched decode, in both
attention modes, give logits allclose at 1e-4 and page pools equal to f32 rounding."""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.models.convert import (pages_from_numpy,  # noqa: E402
                                        params_from_numpy, tree_leaves,
                                        tree_map)
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "tinyllama-1.1b"
PAGE, N_MAX = 8, 4
POOL = 12                       # pages 0..10 live, 11 is the scrap page
POOL_ATOL = 1e-6


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_reduced(ARCH))
    tm = build_model(reduced_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _pools_match(tpages, jpages):
    """Pools agree everywhere but the scrap page (padded rows of both write
    it, and the JAX fused kernel parks its write-backs there), to f32
    rounding: the two frameworks' projections and rope differ in the last
    bit (max 1.2e-7 observed)."""
    def check(t, j):
        np.testing.assert_allclose(t.numpy()[..., :POOL - 1, :, :, :],
                                   np.asarray(j)[..., :POOL - 1, :, :, :],
                                   rtol=0, atol=POOL_ATOL)
    tree_map(check, tpages, jpages)


def test_config_and_geometry_match(models):
    jm, _, tm, _ = models
    assert tm.cfg == reduced_config(ARCH)
    assert tm.cfg.num_units == jm.cfg.num_units
    assert tm.supports_paged() and jm.supports_paged()
    assert tm.kv_bytes_per_token() == jm.kv_bytes_per_token()
    js = jax.tree.leaves(jm.paged_cache_specs(POOL, PAGE))
    ts = tree_leaves(tm.paged_cache_specs(POOL, PAGE))
    assert [tuple(t.shape) for t in ts] == [s.shape for s in js]


def test_init_layout_matches_reference(models):
    jm, jp, tm, tp = models
    mine = tm.init(torch.Generator().manual_seed(0))
    assert len(tree_leaves(mine)) == len(jax.tree.leaves(jp))

    def check(t, j):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    tree_map(check, mine, jp)


@pytest.mark.parametrize("fused", [True, False])
def test_prefill_then_decode_matches_reference(models, fused):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(11)
    V = tm.cfg.vocab_size
    jpages = jm.init_paged_caches(POOL, PAGE)
    j_prefill = jax.jit(jm.prefill_paged)
    j_decode = jax.jit(functools.partial(jm.decode_paged, interpret=True,
                                         fused=fused))
    tpages = pages_from_numpy(jax.tree.map(np.asarray, jpages), "cpu")
    tables = np.asarray([[3, 1, 7, 0], [2, 5, 11, 11], [9, 4, 6, 10]],
                        np.int32)
    lens = [19, 11, 27]
    # chunked prefill per sequence: uneven chunks padded to 16 rows
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
                                      jnp.int32(start),
                                      jnp.asarray(tables[b]), jnp.int32(n))
            tpages = tm.prefill_paged(tp, tpages, torch.tensor(toks), start,
                                      torch.tensor(tables[b]), n)
            start += n
    _pools_match(tpages, jpages)
    # three batched decode steps, sequences at their own positions
    pos = np.asarray(lens, np.int32) - 1
    toks = rng.integers(0, V, size=(3, 1)).astype(np.int32)
    for _ in range(3):
        lj, jpages = j_decode(jp, jpages, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(tables))
        lt, tpages = tm.decode_paged(tp, tpages, torch.tensor(toks),
                                     torch.tensor(pos), torch.tensor(tables),
                                     fused=fused)
        assert lt.dtype == torch.float32 and tuple(lt.shape) == (3, V)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4)
        _pools_match(tpages, jpages)
        toks = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("ffn,paged", [("mlp", True), ("none", True),
                                       ("moe", True)])
def test_supports_paged_agrees_with_layer_apply_paged(ffn, paged,
                                                     monkeypatch):
    """A hand-built attn stack: the predicate says True for every FFN, as
    the reference's does, exactly where ``layer_apply_paged`` takes the
    layer (one decode step through it gives finite rows of the input's
    shape), and ``PagedTorchBackend`` takes the stack."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import layer_apply_paged
    from repro_torch.serving import torch_backend

    cfg = ModelConfig(name="attn-" + ffn, family="dense", num_layers=2,
                      d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                      vocab_size=64, unit_pattern=(("attn", ffn),),
                      num_experts=4 if ffn == "moe" else 0,
                      top_k=2 if ffn == "moe" else 0,
                      d_ff_expert=32 if ffn == "moe" else 0,
                      dtype="float32")
    model = build_model(cfg)
    assert model.supports_paged() is paged
    params = model.init(torch.Generator().manual_seed(0))
    pages = model.init_paged_caches(5, 4, "cpu")
    lp = {name: leaf[0] for name, leaf in params["units"]["l0"].items()}
    up = {name: leaf[0] for name, leaf in pages["units"]["l0"].items()}
    x = params["embed"][torch.tensor([[3], [7]])]
    out, _ = layer_apply_paged(x, lp, "attn", ffn, cfg, "decode", up,
                               torch.tensor([[0, 1], [2, 3]],
                                            dtype=torch.int32),
                               torch.tensor([0, 2], dtype=torch.int32),
                               fused=True)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    monkeypatch.setattr(torch_backend, "get_config", lambda name: cfg)
    be = torch_backend.PagedTorchBackend(arch=cfg.name, reduced=False,
                                         device="cpu")
    assert be.cfg is cfg and be.model.supports_paged()
    # the predicate refuses stacks whose mixers are not attn
    mla = dataclasses.replace(cfg, unit_pattern=(("mla", "mlp"),))
    assert not build_model(mla).supports_paged()
