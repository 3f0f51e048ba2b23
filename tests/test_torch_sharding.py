"""The port's mesh placement (``repro_torch.launch.sharding`` mesh half,
``launch.mesh``, ``models.partition``) against the reference's
``repro.launch.sharding``: every spec of ``param_pspec`` (fsdp and tp
modes), ``opt_shardings``, ``cache_pspec`` (both decode modes),
``batch_shardings`` and ``make_ctx`` equals ``tuple()`` of the
reference's, for every arch, on the production (16, 16) and (2, 16, 16)
meshes and on small ones.  The reference side takes a
``jax.sharding.AbstractMesh``, which needs no devices.  Then the validity
cases of ``tests/test_sharding.py`` on the port."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:   # property tests degrade to sampling
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.launch import sharding as J  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.models.partition import AxisCtx as JCtx  # noqa: E402

from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.partition import AxisCtx, best_axes  # noqa: E402
from repro_torch.training.optimizer import get_optimizer  # noqa: E402

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return Mesh(names, sizes), AbstractMesh(sizes, names)


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return k


def _ref_specs(tree_specs):
    """{path: tuple(spec)} of a reference tree of PartitionSpecs or
    NamedShardings."""
    out = {}

    def f(path, leaf):
        spec = getattr(leaf, "spec", leaf)
        out[tuple(_key(k) for k in path)] = tuple(spec)
        return leaf

    jax.tree_util.tree_map_with_path(
        f, tree_specs, is_leaf=lambda x: not isinstance(x, (dict, list,
                                                            tuple)))
    return out


def _nonempty(specs):
    """Specs without the empty ones: an empty container of the tree (a
    model without prefix layers) and a 0-d leaf's spec look alike."""
    return {p: s for p, s in specs.items() if s != ()}


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (k,)))
        return out
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], dict)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, path + (i,)))
        return out
    return {path: tree}


def _ref_params(arch):
    return jax.eval_shape(j_build(j_get_config(arch)).init,
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name):
    mesh, amesh = _meshes(mesh_name)
    cfg = get_config(arch)
    params = build_model(cfg).param_specs()
    jparams = _ref_params(arch)
    for mode in ("fsdp", "tp"):
        got = _port_specs(sh.params_shardings(cfg, mesh, params, mode))
        want = _ref_specs(jax.tree_util.tree_map_with_path(
            lambda p, l: J.param_pspec(j_get_config(arch), amesh, p,
                                       l.shape, mode), jparams))
        assert got == want, mode
    opt = get_optimizer(cfg).init(params)
    jopt = jax.eval_shape(__import__(
        "repro.training.optimizer", fromlist=["get_optimizer"])
        .get_optimizer(j_get_config(arch)).init, jparams)
    got = _port_specs(sh.opt_shardings(cfg, mesh, opt))
    want = _ref_specs(jax.tree_util.tree_map_with_path(
        lambda p, l: J._generic_spec(amesh, l.shape), jopt))
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_ctx_cache_and_batch_specs_equal_the_reference(arch, mesh_name):
    mesh, amesh = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model, jmodel = build_model(cfg), j_build(jcfg)
    for sname, shape in SHAPES.items():
        for decode_tp in (False, True):
            ctx = sh.make_ctx(cfg, mesh, shape.kind, decode_tp=decode_tp)
            jctx = J.make_ctx(jcfg, amesh, shape.kind, decode_tp=decode_tp)
            for f in ("phase", "batch", "seq", "ep", "ep_axis", "fsdp_axis",
                      "decode_tp", "attn_schedule", "attn_chunk",
                      "seq_shard_states"):
                assert getattr(ctx, f) == getattr(jctx, f), f
            assert ctx.seq_size == jctx.seq_size
            specs = model.input_specs(shape)
            jspecs = jmodel.input_specs(J_SHAPES[sname])
            if shape.kind == "decode":
                got = _port_specs(sh.cache_shardings(ctx, specs["caches"]))
                want = _ref_specs(J.cache_shardings(jctx, jspecs["caches"]))
                assert _nonempty(got) == _nonempty(want)
                got = sh.batch_shardings(ctx, {"tokens": specs["tokens"]})
                want = J.batch_shardings(jctx, {"tokens": jspecs["tokens"]})
                assert got["tokens"] == tuple(want["tokens"].spec)
            else:
                got = _port_specs(sh.batch_shardings(ctx, specs["batch"]))
                want = _ref_specs(J.batch_shardings(jctx, jspecs["batch"]))
                assert got == want
                if shape.kind != "prefill":     # training makes no caches
                    continue
                B, S = shape.global_batch, shape.seq_len
                cache = model.cache_specs(B, S)
                got = _port_specs(sh.cache_shardings(ctx, cache))
                want = _ref_specs(J.cache_shardings(
                    jctx, jmodel.cache_specs(B, S)))
                assert _nonempty(got) == _nonempty(want)


def test_make_ctx_without_a_mesh_equals_the_reference():
    for arch in ARCHS:
        for phase in ("train", "prefill", "decode"):
            a = sh.make_ctx(get_config(arch), None, phase)
            b = J.make_ctx(j_get_config(arch), None, phase)
            assert (a.batch, a.seq, a.ep, a.phase, a.seq_size) == \
                (b.batch, b.seq, b.ep, b.phase, b.seq_size)


def test_production_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    assert m.devices is None
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16} and mp.size == 512
    assert mp.coords(511) == {"pod": 1, "data": 15, "model": 15}
    assert mp.group(17, "model") == tuple(range(16, 32))
    assert mp.group(17, "data") == tuple(range(1, 256, 16))


def test_local_mesh_cpu_only_when_asked():
    m = make_local_mesh(model=2, data=2, device="cpu")
    assert m.shape == {"data": 2, "model": 2}
    assert all(d.type == "cpu" for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_local_mesh(model=2)


# ---------------------------------------------------------------------------
# the validity cases of tests/test_sharding.py, on the port
# ---------------------------------------------------------------------------
MESH = Mesh(("data", "model"), (16, 16))


def _axis_product(mesh, entry):
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _valid(mesh, spec, shape):
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if dim % _axis_product(mesh, entry) != 0:
            return False
    return True


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.sampled_from(
    [1, 2, 7, 8, 16, 24, 56, 128, 384, 2048, 7168, 20480, 73728]),
    min_size=1, max_size=4))
def test_generic_spec_always_divisible(dims):
    spec = sh._generic_spec(MESH, tuple(dims))
    assert _valid(MESH, spec, tuple(dims))


@pytest.mark.parametrize("arch", ["yi-34b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b", "minicpm3-4b"])
@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_param_specs_valid_for_all_leaves(arch, mode):
    cfg = get_config(arch)
    params = build_model(cfg).param_specs()
    specs = _port_specs(sh.params_shardings(cfg, MESH, params, mode))
    leaves = _port_specs(params)
    for path, leaf in leaves.items():
        assert _valid(MESH, specs[path], leaf.shape), (path, leaf.shape)


def test_expert_weights_pinned_for_ep():
    cfg = get_config("kimi-k2-1t-a32b")
    spec = sh.param_pspec(cfg, MESH, ("units", "l0", "w_gate"),
                          (60, cfg.num_experts, cfg.d_model,
                           cfg.d_ff_expert))
    assert spec[1] == "model"          # expert dim on the EP axis
    assert spec[2] == "data"           # d_model storage-sharded


def test_best_axes_prefix_fallback():
    m = {"pod": 2, "data": 16, "model": 16}
    assert best_axes(m, 512, ("pod", "data", "model")) == \
        ("pod", "data", "model")
    assert best_axes(m, 256, ("pod", "data", "model")) == ("pod", "data")
    assert best_axes(m, 1, ("data",)) is None
    assert best_axes(Mesh(("pod", "data", "model"), (2, 16, 16)), 256,
                     ("pod", "data", "model")) == ("pod", "data")


def test_make_ctx_axes():
    ctx = sh.make_ctx(get_config("yi-34b"), None, "train")
    assert ctx.batch == ("data",) and ctx.seq == ("model",)
    xcfg = get_config("xlstm-1.3b")
    ctx_tr = sh.make_ctx(xcfg, None, "train")
    assert ctx_tr.seq == () and "model" in ctx_tr.batch
    assert sh.make_ctx(xcfg, None, "prefill").seq == ("model",)


def test_cache_pspec_decode_modes():
    mesh = Mesh(("data", "model"), (1, 1))
    ctx = AxisCtx(mesh=mesh, batch=("data",), decode_tp=False)
    spec = sh.cache_pspec(ctx, ("units", "l0", "k"), (15, 16, 32768, 8, 128))
    assert spec[2] == "model"          # sequence-sharded cache
    ctx_tp = AxisCtx(mesh=mesh, batch=("data",), decode_tp=True)
    spec2 = sh.cache_pspec(ctx_tp, ("units", "l0", "k"),
                           (15, 16, 32768, 8, 128))
    assert spec2[4] == "model"         # head_dim-sharded cache (TP mode)
    j = J.cache_pspec(JCtx(mesh=AbstractMesh((1, 1), ("data", "model")),
                           batch=("data",), decode_tp=True),
                      (jax.tree_util.DictKey("units"),
                       jax.tree_util.DictKey("l0"),
                       jax.tree_util.DictKey("k")), (15, 16, 32768, 8, 128))
    assert spec2 == tuple(j)


def test_shard_factor():
    assert sh.shard_factor(MESH, (("data", "model"), None)) == 256
    assert sh.shard_factor(MESH, (None, "model")) == 16
    assert sh.shard_factor(MESH, ()) == 1
