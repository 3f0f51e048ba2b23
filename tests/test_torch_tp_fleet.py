"""Tensor-parallel paged serving in the port, part two: fleets of
tensor-parallel replicas (two replicas x tp=2, and a 1 prefill + 1 decode
fleet with live KV migration at tp=2), the KV export/import round trip on
a sharded pool, reduced kimi-k2 at tp=2 (experts replicated, attention
sharded), the shared data group's collective counts at tp=2 and tp=4,
restoring a full checkpoint onto one rank's shard, and the quickstart's
``--tp`` digests.  Reduced configs, f32, CPU ranks, the JAX
package's weights (``tests/test_torch_tp.py`` holds the port's tp=1
streams equal to ``PagedJaxBackend``'s)."""

import multiprocessing

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402

from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.core.baselines import make_scheduler  # noqa: E402
from repro_torch.launch.sharding import (paged_param_specs,  # noqa: E402
                                         shard_tree)
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tree_leaves, tree_map)
from repro_torch.serving import run as T  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402
from repro_torch.training.checkpoint import (CheckpointManager,  # noqa: E402
                                             RankShard)

ARCH = "tinyllama-1.1b"
KIMI = "kimi-k2-1t-a32b"
# tests/test_disagg.py's JAX_SPEC / JAX_KW / JAX_CFG
SPEC = dict(rate=1.5, duration=6.0, seed=0, mix=(2, 1, 1), prompt_cap=40,
            output_cap=12, slo_scale=20.0)
KW = dict(num_blocks=64, page=16, max_len=128, seed=0)
CFG = dict(max_batch=8, prefill_budget=32)


def _jax_weights(arch=ARCH):
    jm = j_build(j_reduced(arch))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def weights():
    return _jax_weights()


def _backend(weights, tp, **kw):
    be = PagedTorchBackend(device="cpu", tp=tp, **dict(KW, **kw))
    be.load_params(weights)
    return be


def _merged(sink):
    return sorted((rid, tuple(int(t) for t in toks))
                  for bk in sink for rid, toks in bk.generated.items())


def _close(backends):
    for be in backends:
        be.close()


def _mk_reqs(n=2, prompt=30, out=10):
    return [Request(rid=i + 1, app="chatbot", arrival=0.0,
                    prompt_len=prompt, true_output_len=out,
                    slo=SLOSpec("throughput", ttlt=1e6))
            for i in range(n)]


# ---------------------------------------------------------------------------
# Fleets
# ---------------------------------------------------------------------------
def _colocated(weights, tp):
    be = _backend(weights, tp)
    try:
        T.run(T.ExperimentSpec(
            scheduler="tempo", workload=WorkloadSpec(**SPEC),
            engine=EngineConfig(tp=tp, **CFG),
            backend=T.BackendSpec(kind=be), warmup=64))
        be.check_ranks()
        return _merged([be])
    finally:
        be.close()


def test_disaggregated_fleet_tp2_streams_equal_colocated(weights):
    """``tests/test_disagg.py``'s tp=2 case: a 1 prefill + 1 decode fleet,
    each replica two ranks, migrates requests live (every rank exports
    its heads, every rank imports its own) and its merged streams equal the
    colocated tp=2 run's and tp=1's."""
    sink = []
    try:
        f = T.run_cluster(T.ExperimentSpec(
            scheduler="tempo", workload=WorkloadSpec(**SPEC),
            engine=EngineConfig(tp=2, **CFG),
            backend=T.BackendSpec(factory=lambda rid: _backend(weights, 2),
                                  sink=sink),
            warmup=64, cluster=T.ClusterSpec(router="disagg",
                                             roles=["prefill", "decode"])))
        for be in sink:
            be.check_ranks()
        got = _merged(sink)
    finally:
        _close(sink)
    assert f.fleet.migrated_in == f.fleet.migrated_out > 0
    assert len(sink) == 2 and all(be.tp == 2 and be.plan["attn"]
                                  for be in sink)
    ref = _colocated(weights, 2)
    assert got == ref == _colocated(weights, 1)


def test_cluster_replicas_with_tp_groups(weights):
    """2 replicas x tp=2 (the default factory of ``run_cluster``, engine
    tp threaded into the backend kwargs): the fleet serves real sharded
    work and per-request streams equal a tp=1 fleet's."""
    def fleet(tp):
        sink = []
        try:
            f = T.run_cluster(T.ExperimentSpec(
                scheduler="tempo", workload=WorkloadSpec(**SPEC),
                engine=EngineConfig(tp=tp, **CFG),
                backend=T.BackendSpec(kind="torch",
                                      kwargs=dict(KW, device="cpu"),
                                      sink=sink),
                warmup=64, cluster=T.ClusterSpec(router="round-robin",
                                                 n_replicas=2)))
            assert min(f.routed.values()) > 0
            assert all(be.tp == tp for be in sink)
            for be in sink:
                be.check_ranks()
            return _merged(sink)
        finally:
            _close(sink)

    assert fleet(2) == fleet(1)


def test_export_import_round_trip_on_a_sharded_pool(weights):
    """An export from a tp=2 pool has the unsharded layout (every rank's
    heads): it imports bitwise into a tp=1 pool and back into a tp=2 pool
    (each rank keeps its own heads), live and swapped out."""
    a, c = _backend(weights, 2), _backend(weights, 2)
    b = _backend(weights, 1)
    try:
        def prefill(be, rid, table):
            r = Request(rid=rid, app="chatbot", arrival=0.0, prompt_len=40,
                        true_output_len=12,
                        slo=SLOSpec("throughput", ttlt=60.0))
            be.begin_step()
            be.prefill_chunk(r, 0, r.prompt_len, table)
            be.step_time(r.prompt_len, [])
            return r

        def pages_at(be, table):
            return be.kv_export_pages(10**7, table)["pages"]

        ta, tb, tc = [0, 1, 2], [60, 7, 33], [90, 11, 64]
        r = prefill(a, 1, ta)
        payload = a.kv_export_pages(r.rid, ta)
        leaves = tree_leaves(payload["pages"])
        assert all(x.shape[-2] == 2 for x in leaves)       # every KV head
        b.kv_import_pages(r.rid, payload, tb)
        c.kv_import_pages(r.rid, payload, tc)
        for got in (pages_at(b, tb), pages_at(c, tc)):
            assert all(np.array_equal(x, y) for x, y in
                       zip(tree_leaves(got), leaves))
        ts = [3, 4, 5]
        r2 = prefill(a, 2, ts)
        want = pages_at(a, ts)
        a.kv_swap_out(r2.rid, ts, r2.prompt_len)
        c.kv_import_pages(r2.rid, a.kv_export_pages(r2.rid, []), None)
        c.kv_swap_in(r2.rid, [100, 3, 50])
        assert all(np.array_equal(x, y) for x, y in
                   zip(tree_leaves(pages_at(c, [100, 3, 50])),
                       tree_leaves(want)))
    finally:
        _close((a, b, c))


def test_kimi_tp2_experts_replicated_streams_equal_tp1():
    """Reduced kimi-k2 at tp=2: attention and the vocab shard, the MoE
    experts (and the dense MLP of its first layer) replicate; streams
    equal tp=1's."""
    w = _jax_weights(KIMI)

    def run(tp):
        be = _backend(w, tp, arch=KIMI, num_blocks=32, max_len=64)
        try:
            eng = ServeEngine(be, make_scheduler("vllm"),
                              EngineConfig(max_batch=4, prefill_budget=16,
                                           tp=tp))
            eng.load(_mk_reqs(n=3, prompt=20, out=8), [])
            assert len(eng.run()) == 3
            be.check_ranks()
            return be, {r: list(t) for r, t in be.generated.items()}
        finally:
            be.close()

    be2, s2 = run(2)
    assert be2.plan == dict(tp=2, attn=True, mlp=False, vocab=True)
    experts = be2.params["units"]["l0"]["w_gate"]
    assert experts.shape[1] == reduced_config(KIMI).num_experts
    assert run(1)[1] == s2


def test_shared_data_group_streams_equal_tp1(weights):
    """The shared data group (slots in shared memory, a barrier on shared
    flags, every rank summing in rank order), which carries the
    collectives of ranks on the CPU or on one card: at tp=2 and the tp=4
    fallback, streams equal tp=1's and every rank counts the same
    collectives."""
    def run(tp):
        be = _backend(weights, tp, num_blocks=16, max_len=64)
        try:
            eng = ServeEngine(be, make_scheduler("tempo",
                                                 use_predictor=False),
                              EngineConfig(max_batch=2, prefill_budget=16,
                                           tp=tp, spec_depth_max=2))
            eng.load(_mk_reqs(n=2), [])
            assert len(eng.run()) == 2
            stats = be.rank_stats()
            return be, stats, {r: list(t) for r, t in be.generated.items()}
        finally:
            be.close()

    _, _, ref = run(1)
    for tp in (2, 4):
        be, stats, got = run(tp)
        assert got == ref
        assert {s["data"] for s in stats} == {"shared"}
        assert len({s["collectives"] for s in stats}) == 1
        assert len({s["digest"] for s in stats}) == 1
        # per decode forward: an all-reduce after wo (when attention
        # shards) and after w_down in every layer, then the vocab gather
        p = be.plan
        per = be.cfg.num_layers * (p["attn"] + p["mlp"]) + p["vocab"]
        assert stats[0]["collectives"] >= per * be.n_decode_forwards > 0


# ---------------------------------------------------------------------------
# Sharded restore
# ---------------------------------------------------------------------------
def test_restore_full_checkpoint_onto_each_ranks_shard(tmp_path, weights):
    """The counterpart of the reference's elastic restore: a checkpoint of
    the full weights restores onto each rank's shard under the serving
    specs, each leaf equal to that rank's slice, the ranks' slices making
    up the full leaf."""
    cfg = reduced_config(ARCH)
    full = params_from_numpy(weights, "cpu")
    cm = CheckpointManager(str(tmp_path), keep=1)
    cm.save(7, full)
    specs = paged_param_specs(cfg, 2, full)
    got = []
    for rank in (0, 1):
        like = shard_tree(full, specs, rank, 2)
        like = tree_map(lambda t: torch.zeros_like(t), like)
        params, _, meta = cm.restore(7, like,
                                     param_shardings=RankShard(specs, rank,
                                                               2))
        assert meta["step"] == 7
        want = shard_tree(full, specs, rank, 2)
        for x, y in zip(tree_leaves(params), tree_leaves(want)):
            assert x.shape == y.shape and torch.equal(x, y)
        got.append(params)
    wq = full["units"]["l0"]["wq"]
    assert torch.equal(torch.cat([g["units"]["l0"]["wq"] for g in got],
                                 dim=2), wq)
    assert torch.equal(got[0]["embed"], full["embed"])   # replicated


# ---------------------------------------------------------------------------
# The quickstart
# ---------------------------------------------------------------------------
def _digests(capsys, tp):
    from repro_torch.examples.quickstart import main
    main(["--backend", "torch", "--device", "cpu", "--tp", str(tp)])
    return [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("stream-digest")]


def test_quickstart_tp_prints_the_tp1_digests(capsys):
    ref = _digests(capsys, 1)
    assert len(ref) == 2
    assert _digests(capsys, 2) == ref
    assert _digests(capsys, 4) == ref
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith("tp-rank-")]
