"""Tensor-parallel paged serving in the port (DESIGN.md §8): the cases of
``tests/test_tp.py`` on ``PagedTorchBackend(tp=N)``, its ranks CPU
processes joined by the shared-memory data group (reduced configs, f32,
the kernels' plain versions).

The plan and the weights' and pool's specs equal the reference's for every
leaf of every paged architecture, reduced and full.  One sharded paged
decode layer (two ranks in threads) computes the unsharded layer's output.
Token streams at tp=2 and in the tp=4 fallback (reduced tinyllama has
KV=2: attention and its pool replicate while the MLP and vocab shard) are
byte-identical to the port's tp=1 streams and to ``PagedJaxBackend``'s
(tp=1; the reference's own tests hold its tp=2 equal to its tp=1), with
the JAX package's weights carried across (``load_params``).  The ranks'
lifecycle: a killed or stopped worker makes rank 0 raise; no child is
left after ``close``; the ranks' token hashes agree, and a disagreement
raises.  Fleets, migration, the shared-buffer data group and the sharded
restore are in ``tests/test_torch_tp_fleet.py``."""

import multiprocessing
import os
import signal
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.launch import sharding as J  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402

from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.launch.sharding import (paged_page_specs,  # noqa: E402
                                         paged_param_specs, paged_tp_plan,
                                         serving_tp_ctx, shard_tree)
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tree_leaves)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import layer_apply_paged  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving import tp as TP  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402

ARCH = "tinyllama-1.1b"
PAGED = [a for a in list_archs() if build_model(reduced_config(a))
         .supports_paged()]


def _jax_weights(arch=ARCH):
    """The JAX package's reduced weights for seed 0 (what
    ``PagedJaxBackend(seed=0)`` serves), as numpy."""
    jm = j_build(j_reduced(arch))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def weights():
    return _jax_weights()


# ---------------------------------------------------------------------------
# Plan / spec unit tests (no ranks needed)
# ---------------------------------------------------------------------------
def test_paged_tp_plan_divisibility():
    cfg = reduced_config(ARCH)                 # H=4, KV=2, d_ff=128, V=256
    assert paged_tp_plan(cfg, 1) == dict(tp=1, attn=False, mlp=False,
                                         vocab=False)
    p2 = paged_tp_plan(cfg, 2)
    assert p2["attn"] and p2["mlp"] and p2["vocab"]
    p4 = paged_tp_plan(cfg, 4)                 # KV=2 % 4 != 0 -> fallback
    assert not p4["attn"] and p4["mlp"] and p4["vocab"]


class _Shape:
    """A leaf standing in for a weight: its shape and ndim."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def _is_spec(t):
    """A spec tuple (an empty tuple is an empty node: no leaf is 0-d)."""
    return isinstance(t, tuple) and len(t) > 0 and all(
        a is None or isinstance(a, str) for a in t)


def _by_path(tree, path=()):
    """{path: leaf} of a port tree; a spec tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _by_path(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _by_path(sub, path + (i,)).items()}
    return {path: tree}


def _jax_by_path(tree, is_leaf=None):
    """{path: leaf} of a JAX tree, paths as ``_by_path``'s."""
    def key(k):
        return getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(key(k) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", PAGED)
def test_plans_and_specs_equal_the_reference(arch, reduced):
    """For every paged arch and tp in {1, 2, 4, 8}: the plan equals
    ``paged_tp_plan``'s, every weight's and every pool's spec equals
    ``tuple(PartitionSpec)`` of the reference's, every sharded dim divides
    by tp, and GQA groups stay whole."""
    from jax.sharding import PartitionSpec as P

    jcfg = j_reduced(arch) if reduced else j_get_config(arch)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    jm = j_build(jcfg)
    shapes = _jax_by_path(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    params = {}                     # the port's layout, leaves as _Shape
    for path, leaf in shapes.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _Shape(leaf.shape)
    pages = build_model(cfg).paged_cache_specs(8, 16)
    is_p = lambda x: isinstance(x, P)                       # noqa: E731
    for tp in (1, 2, 4, 8):
        plan = paged_tp_plan(cfg, tp)
        assert plan == J.paged_tp_plan(jcfg, tp)
        ref = {k: tuple(s) for k, s in _jax_by_path(
            J.paged_param_specs(jcfg, tp, jax.eval_shape(
                jm.init, jax.random.PRNGKey(0))), is_p).items()}
        got = _by_path(paged_param_specs(cfg, tp, params))
        assert got == ref and len(got) == len(shapes)
        for path, spec in got.items():
            for dim, ax in zip(shapes[path].shape, spec):
                if ax is not None:
                    assert dim % tp == 0, (path, spec, tp)
        if plan["attn"]:
            assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
        ref_pages = {k: tuple(s) for k, s in _jax_by_path(
            J.paged_page_specs(jcfg, tp, pages), is_p).items()}
        got_pages = _by_path(paged_page_specs(cfg, tp, pages))
        assert got_pages == ref_pages
        for path, leaf in _by_path(pages).items():
            spec = got_pages[path]
            assert (spec[leaf.ndim - 2] == "model") == plan["attn"]


def test_shard_tree_gives_contiguous_slices_of_their_own():
    cfg = reduced_config(ARCH)
    full = params_from_numpy(_jax_weights(), "cpu")
    specs = paged_param_specs(cfg, 2, full)
    parts = [_by_path(shard_tree(full, specs, r, 2)) for r in (0, 1)]
    specs = _by_path(specs)
    for path, path_leaf in _by_path(full).items():
        s0, s1, spec = parts[0][path], parts[1][path], specs[path]
        if "model" not in spec:
            assert s0 is path_leaf and s1 is path_leaf
            continue
        dim = spec.index("model")
        assert s0.is_contiguous() and s1.is_contiguous()
        assert s0.untyped_storage().data_ptr() != \
            path_leaf.untyped_storage().data_ptr()
        assert torch.equal(torch.cat([s0, s1], dim=dim), path_leaf)


# ---------------------------------------------------------------------------
# One sharded paged decode layer
# ---------------------------------------------------------------------------
class _ThreadGroup:
    """The collective handle of ``models.partition`` for ranks that are
    threads of one process: each all-reduce sums the ranks' pieces in rank
    order."""

    def __init__(self, size):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)

    def rank(self, r):
        group = self

        class Handle:
            def _swap(self, x):
                group.slots[r] = x
                group.barrier.wait()
                got = list(group.slots)
                group.barrier.wait()
                return got

            def all_reduce(self, x):
                got = self._swap(x)
                out = got[0] + got[1]
                for t in got[2:]:
                    out = out + t
                return out

            def all_gather(self, x):
                return torch.cat(self._swap(x), dim=-1)

        return Handle()


def test_sharded_decode_layer_equals_unsharded(weights):
    """One paged decode layer at tp=2 (wq/wk/wv/wo by heads, the MLP by
    d_ff, the pool by KV heads; two ranks in threads, their partial wo and
    w_down products all-reduced) gives the unsharded layer's output within
    1e-5, and each rank's pool holds its heads of the unsharded pool."""
    cfg = reduced_config(ARCH)
    full = params_from_numpy(weights, "cpu")
    lp = {k: v[0] for k, v in full["units"]["l0"].items()}
    model = build_model(cfg)
    rng = np.random.default_rng(3)
    B, n_pages, page = 4, 9, 16
    pool = model.init_paged_caches(n_pages, page, "cpu")["units"]["l0"]
    pool = {k: torch.from_numpy(rng.normal(size=v[0].shape).astype(
        np.float32)) for k, v in pool.items()}
    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(
        np.float32))
    tables = torch.from_numpy(rng.permutation(8).reshape(B, 2).astype(
        np.int32))
    pos = torch.tensor([0, 5, 17, 31], dtype=torch.int32)
    ref_pool = {k: v.clone() for k, v in pool.items()}
    ref, _ = layer_apply_paged(x, lp, "attn", "mlp", cfg, "decode",
                               ref_pool, tables, pos, fused=True)

    group = _ThreadGroup(2)
    pspecs = paged_param_specs(cfg, 2, {"units": {"l0": full["units"]
                                                  ["l0"]}})
    lspecs = {k: s[1:] for k, s in pspecs["units"]["l0"].items()}
    gspecs = {k: (None, None, "model", None) for k in pool}
    out, pools = [None, None], [None, None]

    def rank(r):
        ctx = serving_tp_ctx(cfg, 2, group.rank(r))
        mine = shard_tree(lp, lspecs, r, 2)
        pools[r] = shard_tree(pool, gspecs, r, 2)
        out[r], _ = layer_apply_paged(x, mine, "attn", "mlp", cfg, "decode",
                                      pools[r], tables, pos, fused=True,
                                      ctx=ctx)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    torch.testing.assert_close(out[0], ref, rtol=0, atol=1e-5)
    assert torch.equal(out[0], out[1])
    for k in pool:
        assert torch.equal(torch.cat([pools[0][k], pools[1][k]], dim=2),
                           ref_pool[k])


# ---------------------------------------------------------------------------
# Engine-level stream equivalence
# ---------------------------------------------------------------------------
def _mk_reqs(n=2, prompt=30, out=10, kind="throughput"):
    return [Request(rid=i + 1, app="chatbot", arrival=0.0,
                    prompt_len=prompt, true_output_len=out,
                    slo=SLOSpec(kind, ttlt=1e6))
            for i in range(n)]


def _backend(weights, tp, **kw):
    kw.setdefault("seed", 0)
    be = PagedTorchBackend(page=16, device="cpu", tp=tp, **kw)
    be.load_params(weights)
    return be


def _streams(be, fin):
    return {r.rid: list(be.generated[r.rid]) for r in fin}


def _run(weights, tp, num_blocks=4, temperature=0.0, top_k=0, n=2):
    """Tiny pool (4 blocks per rank) so prefill+decode cross page
    boundaries with the pool exhausted: at least one eviction round-trips
    through host copies on the sharded pool too."""
    be = _backend(weights, tp, num_blocks=num_blocks, max_len=64,
                  temperature=temperature, top_k=top_k)
    try:
        eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                          EngineConfig(max_batch=2, prefill_budget=16,
                                       tp=tp))
        eng.load(_mk_reqs(n=n), [])
        fin = eng.run()
        assert len(fin) == n
        be.check_ranks()
        return eng, be, _streams(be, fin)
    finally:
        be.close()


def _jax_run(num_blocks=4, temperature=0.0, top_k=0, n=2):
    from repro.core.baselines import make_scheduler as j_make_scheduler
    from repro.serving.engine import (EngineConfig as JEngineConfig,
                                      ServeEngine as JServeEngine)
    from repro.serving.jax_backend import PagedJaxBackend
    from repro.serving.request import Request as JRequest, SLOSpec as JSLO

    be = PagedJaxBackend(num_blocks=num_blocks, page=16, max_len=64, seed=0,
                         temperature=temperature, top_k=top_k)
    eng = JServeEngine(be, j_make_scheduler("tempo", use_predictor=False),
                       JEngineConfig(max_batch=2, prefill_budget=16))
    eng.load([JRequest(rid=i + 1, app="chatbot", arrival=0.0, prompt_len=30,
                       true_output_len=10, slo=JSLO("throughput", ttlt=1e6))
              for i in range(n)], [])
    fin = eng.run()
    return {r.rid: list(be.generated[r.rid]) for r in fin}


def test_tp2_streams_identical_greedy(weights):
    _, be1, s1 = _run(weights, tp=1)
    _, be2, s2 = _run(weights, tp=2)
    assert be2.plan["attn"], "KV=2 must shard at tp=2"
    assert be2.num_blocks == 2 * be1.num_blocks   # mesh-wide aggregate pool
    assert be2.kv_shard_degree == 2
    # each rank's pool: twice the pages (plus the scrap page), half the
    # KV heads
    for p1, p2 in zip(tree_leaves(be1.pages), tree_leaves(be2.pages)):
        want = list(p1.shape)
        want[p1.ndim - 4] = 2 * 4 + 1
        want[p1.ndim - 2] //= 2
        assert list(p2.shape) == want
    assert s1 == s2 == _jax_run()


def test_tp2_streams_identical_seeded_temperature(weights):
    _, _, s1 = _run(weights, tp=1, temperature=0.8, top_k=20, n=3)
    _, _, s2 = _run(weights, tp=2, temperature=0.8, top_k=20, n=3)
    assert s1 == s2 == _jax_run(temperature=0.8, top_k=20, n=3)


def test_tp2_multi_step_decode_streams_identical(weights):
    """Multi-step decode windows run on every rank, so n=4 at tp=2
    reproduces the tp=1 single-step streams byte for byte."""
    def run(tp, decode_steps):
        be = _backend(weights, tp, num_blocks=16, max_len=64)
        try:
            eng = ServeEngine(be, make_scheduler("tempo",
                                                 use_predictor=False),
                              EngineConfig(max_batch=2, prefill_budget=16,
                                           tp=tp, decode_steps=decode_steps))
            eng.load(_mk_reqs(n=2), [])
            fin = eng.run()
            assert len(fin) == 2
            if decode_steps > 1:
                assert any(k[0] == "decode" and k[2] > 1
                           for k in be._shapes), "fast path never engaged"
            return _streams(be, fin)
        finally:
            be.close()

    ref = run(tp=1, decode_steps=1)
    assert run(tp=2, decode_steps=4) == ref
    assert run(tp=1, decode_steps=4) == ref


def test_tp2_spec_streams_identical(weights):
    """Speculative decoding at tp=2: the verify forward runs on every rank
    and accept/reject happens on logits equal on every rank, so spec-on
    tp=2 streams equal plain tp=1 byte for byte."""
    def run(tp, depth):
        be = _backend(weights, tp, num_blocks=16, max_len=64)
        try:
            eng = ServeEngine(be, make_scheduler("tempo",
                                                 use_predictor=False),
                              EngineConfig(max_batch=2, prefill_budget=16,
                                           tp=tp, spec_depth_max=depth))
            eng.load([Request(rid=i + 1, app="chatbot", arrival=0.0,
                              prompt_len=20 + 3 * i, true_output_len=12,
                              slo=SLOSpec("throughput", ttlt=1e6))
                      for i in range(2)], [])
            fin = eng.run()
            assert len(fin) == 2
            if depth:
                assert eng.spec_proposed > 0, "spec path never engaged"
                assert be.n_verify_forwards > 0
            return _streams(be, fin)
        finally:
            be.close()

    ref = run(tp=1, depth=0)
    assert run(tp=2, depth=4) == ref
    assert run(tp=1, depth=4) == ref


def test_tp2_swap_roundtrip_byte_exact(weights):
    """Evictions on the SHARDED pool (2 blocks per rank, 4 in all) restore
    KV byte-exactly: streams equal the no-eviction tp=1 big pool's."""
    eng, _, small = _run(weights, tp=2, num_blocks=2)
    assert eng.swap_bytes > 0, "pool too large: no eviction exercised"
    _, _, big = _run(weights, tp=1, num_blocks=32)
    assert small == big


def test_tp4_replicated_kv_fallback_streams_identical(weights):
    """num_kv_heads=2 % tp=4 != 0: attention falls back to replication
    (pool unscaled) while MLP and vocab still shard; streams stay exact."""
    _, be4, s4 = _run(weights, tp=4)
    assert not be4.plan["attn"] and be4.plan["mlp"] and be4.plan["vocab"]
    assert be4.num_blocks == 4      # no aggregate scaling when replicated
    assert be4.kv_shard_degree == 1
    _, _, s1 = _run(weights, tp=1)
    assert s1 == s4 == _jax_run()


def test_tp2_prefix_cache_cow_byte_identical_on_vs_off(weights):
    """Prefix-cache adoption and COW forks on a KV-head-sharded pool: the
    cache-on multiturn run emits the cache-off streams exactly."""
    from repro_torch.serving.workload import WorkloadGen, WorkloadSpec

    def run_mt(cache):
        spec = WorkloadSpec(scenario="multiturn", rate=0.5, duration=8.0,
                            seed=0, turns=(2, 3), think_time=40.0,
                            system_prompt_len=8, shared_system_frac=1.0,
                            prompt_cap=8, output_cap=4, slo_scale=50.0)
        gen = WorkloadGen(spec)
        be = _backend(weights, 2, num_blocks=32, max_len=128)
        try:
            eng = ServeEngine(be, make_scheduler("sarathi"),
                              EngineConfig(max_batch=4, prefill_budget=32,
                                           prefix_cache=cache, tp=2),
                              workload=gen)
            singles, dags = gen.generate()
            eng.load(singles, dags)
            fin = eng.run()
            return eng, _streams(be, fin)
        finally:
            be.close()

    eon, on = run_mt(True)
    eoff, off = run_mt(False)
    assert on == off
    assert eon.prefix_hits > 0 and eon.cow_forks > 0
    eon.kv.check_invariants()


def test_tp2_streams_identical_with_telemetry(weights):
    """Telemetry is observation-only on the sharded path too: a tp=2 run
    with registry+tracer attached emits the same streams and records the
    backend's counters."""
    from repro_torch.obs import MetricsRegistry, Tracer

    def run_obs(telemetry):
        be = _backend(weights, 2, num_blocks=4, max_len=64)
        extra = dict(obs=MetricsRegistry(), tracer=Tracer()) \
            if telemetry else {}
        try:
            eng = ServeEngine(be, make_scheduler("tempo",
                                                 use_predictor=False),
                              EngineConfig(max_batch=2, prefill_budget=16,
                                           tp=2), **extra)
            eng.load(_mk_reqs(n=2), [])
            fin = eng.run()
            return _streams(be, fin), extra.get("obs")
        finally:
            be.close()

    s_off, _ = run_obs(False)
    s_on, obs = run_obs(True)
    assert s_on == s_off
    assert obs.value_of("torch_dispatch_seconds_total") > 0
    assert obs.value_of("torch_pages_touched_total") > 0


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------
def _engine(be, tp):
    eng = ServeEngine(be, make_scheduler("tempo", use_predictor=False),
                      EngineConfig(max_batch=2, prefill_budget=16, tp=tp))
    eng.load(_mk_reqs(n=2), [])
    return eng


def _children():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("tp-rank-")]


def test_killed_worker_makes_rank0_raise(weights):
    be = _backend(weights, 2, num_blocks=16, max_len=64)
    proc = be._group._procs[0]
    proc.kill()
    proc.join(10)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        _engine(be, 2).run()
    assert time.monotonic() - t0 < 10
    with pytest.raises(RuntimeError):
        be.close()                      # its hash cannot be checked
    assert be.worker_exitcodes == [-signal.SIGKILL]
    assert not _children()


def test_stopped_worker_makes_rank0_raise_within_the_timeout(
        weights, monkeypatch):
    """A worker that stops answering (SIGSTOP) makes rank 0's collective
    raise once the group's timeout has passed, never hang.  The timeout
    also bounds a reply, which waits for the worker to start: 15 s leaves
    room for a loaded host."""
    monkeypatch.setattr(TP, "TIMEOUT", 15.0)
    be = _backend(weights, 2, num_blocks=16, max_len=64)
    assert be.data.kind == "shared"
    proc = be._group._procs[0]
    os.kill(proc.pid, signal.SIGSTOP)
    t0 = time.monotonic()
    try:
        with pytest.raises((RuntimeError, TimeoutError)):
            _engine(be, 2).run()
        assert time.monotonic() - t0 < 60
    finally:
        proc.kill()
        proc.join(10)
        with pytest.raises(RuntimeError):
            be.close()
    assert not _children()


def test_close_leaves_no_child_and_the_hashes_agree(weights):
    be = _backend(weights, 2, num_blocks=16, max_len=64)
    assert len(_children()) == 1
    _engine(be, 2).run()
    stats = be.rank_stats()
    assert [s["rank"] for s in stats] == [0, 1]
    assert stats[0]["digest"] == stats[1]["digest"]
    be.check_ranks()
    be._hash.update(b"a token rank 1 did not sample")
    with pytest.raises(RuntimeError, match="disagree"):
        be.check_ranks()
    with pytest.raises(RuntimeError, match="disagree"):
        be.close()
    assert be.worker_exitcodes == [0]
    assert not _children()
    be.close()                          # a second close does nothing


def test_close_raises_when_a_worker_fails_on_its_way_out(weights):
    """A worker that exits with another code than 0 makes ``close``
    raise, with the hashes in agreement."""
    be = _backend(weights, 2, num_blocks=16, max_len=64)
    _engine(be, 2).run()
    be._group.send("no_such_method", ())      # the worker exits with 1
    with pytest.raises(RuntimeError, match="exit codes"):
        be.close()
    assert be.worker_exitcodes != [0]
    assert not _children()


@pytest.mark.parametrize("devices, kind", [
    (["cpu"] * 2, "shared"), (["cuda:0"] * 4, "shared"),
    (["cuda:0", "cuda:1"], "nccl"), (["cpu", "cuda:0"], ValueError),
    (["cuda:0", "cuda:0", "cuda:1"], ValueError)])
def test_data_kind_follows_the_ranks_devices(devices, kind):
    """Ranks on the CPU or on one shared card exchange through shared
    buffers, ranks with a card each through NCCL; nothing else is a
    group."""
    devs = [torch.device(d) for d in devices]
    if kind is ValueError:
        with pytest.raises(ValueError):
            TP.data_kind(devs)
    else:
        assert TP.data_kind(devs) == kind
