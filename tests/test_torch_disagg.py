"""Prefill/decode disaggregation with live KV migration on the port's
``PagedTorchBackend`` (reduced tinyllama, ``device="cpu"``, the JAX
package's weights carried across with ``params_from_numpy``): a 1 prefill
+ 1 decode fleet's merged token streams equal the port's colocated
streams and the JAX package's disaggregated streams
(``tests/test_disagg.py``'s settings), with migrations happening; the
export/import round trip is bitwise, live and swapped; a JAX payload
imports into the port.  Streams are compared exactly; page pools across
frameworks at atol 1e-6 (f32 rounding of projections and rope differs by
an ulp).  Also the port's entry points that serve the real backend."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402

from repro.serving import run as J  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.jax_backend import PagedJaxBackend  # noqa: E402
from repro.serving.request import (  # noqa: E402
    Request as JRequest, SLOSpec as JSLO)
from repro.serving.workload import WorkloadSpec as JWorkloadSpec  # noqa: E402

from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tree_leaves)
from repro_torch.serving import run as T  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.request import Request, SLOSpec  # noqa: E402
from repro_torch.serving.torch_backend import PagedTorchBackend  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

# tests/test_disagg.py's JAX_SPEC / JAX_KW / JAX_CFG
SPEC = dict(rate=1.5, duration=6.0, seed=0, mix=(2, 1, 1), prompt_cap=40,
            output_cap=12, slo_scale=20.0)
KW = dict(num_blocks=64, page=16, max_len=128, seed=0)
CFG = dict(max_batch=8, prefill_budget=32)
ROLES = ["prefill", "decode"]
POOL_ATOL = 1e-6


def _merged(sink):
    return sorted((rid, tuple(int(t) for t in toks))
                  for bk in sink for rid, toks in bk.generated.items())


@pytest.fixture(scope="module")
def jax_disagg():
    """The JAX package's disaggregated run: (merged streams, migrated in,
    its weights as numpy)."""
    sink = []
    f = J.run_cluster(J.ExperimentSpec(
        scheduler="tempo", workload=JWorkloadSpec(**SPEC),
        engine=JEngineConfig(**CFG),
        backend=J.BackendSpec(kind="jax", kwargs=dict(KW), sink=sink),
        warmup=64, cluster=J.ClusterSpec(router="disagg", roles=ROLES)))
    return (_merged(sink), f.fleet.migrated_in,
            jax.tree.map(np.asarray, sink[0].params))


def _backend(params, **kw):
    be = PagedTorchBackend(device="cpu", **dict(KW, **kw))
    be.params = params_from_numpy(params, "cpu")
    return be


def _fleet(params, prompts=None, **cluster):
    sink = []
    f = T.run_cluster(T.ExperimentSpec(
        scheduler="tempo", workload=WorkloadSpec(**SPEC),
        engine=EngineConfig(**CFG), prompts=prompts,
        backend=T.BackendSpec(factory=lambda rid: _backend(params),
                              sink=sink),
        warmup=64, cluster=T.ClusterSpec(**cluster)))
    return _merged(sink), f, sink


def _colocated(params, prompts=None):
    be = _backend(params)
    T.run(T.ExperimentSpec(
        scheduler="tempo", workload=WorkloadSpec(**SPEC),
        engine=EngineConfig(**CFG), prompts=prompts,
        backend=T.BackendSpec(kind=be), warmup=64))
    return _merged([be])


def test_disaggregated_streams_equal_colocated_and_the_reference(
        jax_disagg):
    ref, j_migrated, params = jax_disagg
    got, f, sink = _fleet(params, router="disagg", roles=ROLES)
    assert j_migrated > 0
    assert f.fleet.migrated_in == f.fleet.migrated_out > 0
    assert [s.migrated_out for _, s in sorted(f.per_replica.items())][0] \
        == f.fleet.migrated_in                # the prefill side sent them
    assert len(sink) == 2 and {str(b.device) for b in sink} == {"cpu"}
    assert got == _colocated(params)
    assert got == ref


def test_routed_fleet_streams_equal_colocated(jax_disagg):
    """Two replicas under slo-margin: both are routed requests, and the
    merged streams do not depend on which replica served a request."""
    _, _, params = jax_disagg
    got, f, _ = _fleet(params, router="slo-margin", n_replicas=2)
    assert min(f.routed.values()) > 0
    assert got == _colocated(params)


def test_fleet_applies_prompts_like_run(jax_disagg):
    _, _, params = jax_disagg

    def motif(r):
        return ([3, 1, 4] * r.prompt_len)[:r.prompt_len] if r.rid % 2 \
            else None

    got, f, _ = _fleet(params, prompts=motif, router="disagg", roles=ROLES)
    assert f.fleet.migrated_in > 0
    assert got == _colocated(params, prompts=motif)
    assert got != _colocated(params)


def test_fleet_runs_on_the_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_cluster(T.ExperimentSpec(
            workload=WorkloadSpec(**SPEC), engine=EngineConfig(**CFG),
            backend=T.BackendSpec(kind="torch", kwargs=dict(KW)),
            cluster=T.ClusterSpec(router="disagg", roles=ROLES)))


# ---------------------------------------------------------------------------
# export / import
# ---------------------------------------------------------------------------
def _req(cls, slo, rid, prompt=40, out=12):
    return cls(rid=rid, app="chatbot", arrival=0.0, prompt_len=prompt,
               true_output_len=out, slo=slo("throughput", ttlt=60.0))


def _prefill(be, req, table):
    be.begin_step()
    be.prefill_chunk(req, 0, req.prompt_len, table)
    be.step_time(req.prompt_len, [])


def _pages(be, table):
    return [np.asarray(leaf[:, table] if leaf.ndim == 5 else leaf[table])
            for leaf in tree_leaves(be.pages)]


def test_export_import_round_trip_is_bitwise(jax_disagg):
    """Live: prefill on A, export, import into B at other page indices.
    Swapped: a payload exported with an empty table (host copy) parks on B
    and ``kv_swap_in`` restores it.  Both bitwise, prompt and generated
    tokens carried along."""
    _, _, params = jax_disagg
    a, b = _backend(params), _backend(params)
    live, swapped = _req(Request, SLOSpec, 7), _req(Request, SLOSpec, 8)
    ta, tb = [0, 1, 2], [40, 9, 33]
    _prefill(a, live, ta)
    a.generated[7] = [5, 6]
    prompt = a.prompt_ids(live).copy()
    payload = a.kv_export_pages(7, ta)
    assert 7 not in a.generated
    b.kv_import_pages(7, payload, tb)
    assert all(np.array_equal(x, y)
               for x, y in zip(_pages(a, ta), _pages(b, tb)))
    assert np.array_equal(b.prompt_ids(live), prompt)
    assert b.generated[7] == [5, 6]

    ts, tb2 = [3, 4, 5], [60, 61, 12]
    _prefill(a, swapped, ts)
    a.kv_swap_out(8, ts, 40)
    payload = a.kv_export_pages(8, [])
    b.kv_import_pages(8, payload, None)
    assert 8 in b._host
    b.kv_swap_in(8, tb2)
    assert all(np.array_equal(x, y)
               for x, y in zip(_pages(a, ts), _pages(b, tb2)))


def test_bf16_pages_cross_the_host_as_int16_patterns(jax_disagg):
    _, _, params = jax_disagg
    a, b = _backend(params), _backend(params)
    g = torch.Generator().manual_seed(0)
    for be in (a, b):
        for leaf in tree_leaves(be.pages):
            leaf.data = torch.randn(leaf.shape, generator=g).to(
                torch.bfloat16)
    ta, tb = [1, 2], [50, 3]
    payload = a.kv_export_pages(9, ta)
    assert {x.dtype for x in tree_leaves(payload["pages"])} == \
        {np.dtype(np.int16)}
    b.kv_import_pages(9, payload, tb)
    for x, y in zip(tree_leaves(a.pages), tree_leaves(b.pages)):
        assert torch.equal(x[:, ta] if x.ndim == 5 else x[ta],
                           y[:, tb] if y.ndim == 5 else y[tb])


def test_jax_payload_imports_into_the_port(jax_disagg):
    """The payloads share the reference's layout: the JAX backend's export
    of a prefilled request lands in the port's pool, equal to the port's
    own prefill of it at the pools' cross-framework tolerance."""
    _, _, params = jax_disagg
    bj = PagedJaxBackend(**KW)
    bj.params = jax.tree.map(jax.numpy.asarray, params)
    table = [4, 5, 6]
    _prefill(bj, _req(JRequest, JSLO, 11), table)
    payload = bj.kv_export_pages(11, table)
    mine = _backend(params)
    _prefill(mine, _req(Request, SLOSpec, 11), table)
    dst = _backend(params)
    dst.kv_import_pages(11, payload, [20, 21, 22])
    assert np.array_equal(dst.prompt_ids(_req(Request, SLOSpec, 11)),
                          payload["prompt"])
    for x, y in zip(_pages(mine, table), _pages(dst, [20, 21, 22])):
        np.testing.assert_allclose(x, y, rtol=0, atol=POOL_ATOL)


# ---------------------------------------------------------------------------
# entry points on the real backend
# ---------------------------------------------------------------------------
def _digests(out):
    return [ln for ln in out.splitlines() if ln.startswith("stream-digest")]


def test_quickstart_disagg_digests_equal_colocated(capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--backend", "torch", "--device", "cpu"])
    colocated = _digests(capsys.readouterr().out)
    quickstart.main(["--backend", "torch", "--device", "cpu",
                     "--disagg", "1:1"])
    out = capsys.readouterr().out
    assert "migrated" in out and "migrated 0 " not in out
    assert len(colocated) == 2 and _digests(out) == colocated


def test_quickstart_refuses_tp_and_runs_on_the_gpu_by_default():
    from repro_torch.examples import quickstart

    # --tp N runs tensor-parallel (tests/test_torch_tp_fleet.py); a degree
    # below 1 is refused
    with pytest.raises(SystemExit):
        quickstart.main(["--backend", "torch", "--device", "cpu",
                         "--tp", "0"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["--backend", "torch"])


def test_real_entry_points_serve_on_the_cpu(capsys):
    import json

    from repro_torch.examples import serve_mixed_slo
    from repro_torch.launch import serve

    serve.main(["--real", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out)
    assert row["n"] == row["n_admitted"] > 0 and row["goodput_frac"] > 0
    serve_mixed_slo.main(["--real", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("done=True") == 6 and "OK" in out
