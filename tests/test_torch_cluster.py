"""The port's cluster layer (``repro_torch.cluster`` and ``run_cluster``)
against the JAX package's on the simulated backend.  The sim is
deterministic, so for the same ``ExperimentSpec`` fields the port's fleet
summary row must EQUAL the reference's: every router, disaggregated roles
with live migration, the autoscaler, the scan event loop, tenants, the
legacy shims, and the telemetry report.  Also the port's examples and
``launch/serve.py`` entry point on the sim."""

import json
import os
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

from repro.cluster.autoscaler import (  # noqa: E402
    AutoscalerConfig as JAutoscalerConfig)
from repro.cluster.router import ROUTERS as JROUTERS  # noqa: E402
from repro.serving import run as J  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.workload import WorkloadSpec as JWorkloadSpec  # noqa: E402

from repro_torch.cluster.autoscaler import AutoscalerConfig  # noqa: E402
from repro_torch.cluster.router import ROUTERS  # noqa: E402
from repro_torch.serving import run as T  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

TRACES = os.path.join(os.path.dirname(__file__), "..", "experiments",
                      "traces")
SMALL = dict(rate=8.0, duration=2.0, seed=1)
CONTENDED = dict(rate=20.0, duration=4.0, seed=5, mix=(3, 2, 0),
                 slo_scale=0.25, system_prompt_len=1465,
                 shared_system_frac=1.0)
TENANTED = dict(rate=24.0, duration=5.0, seed=5, arrival="trace",
                trace=os.path.join(TRACES, "diurnal.json"),
                tenant_mix=(0.6, 0.3, 0.1))
RAMP = dict(rate=6.0, duration=12.0, seed=3, ramp_peak=5.0)
AUTOSCALE = dict(min_replicas=1, max_replicas=4, cooldown=2.0, window=4.0)


def _exp(pkg, scheduler="tempo", workload=SMALL, engine=None, cluster=None,
         autoscaler=None, warmup=64, metrics_out=None):
    """One ExperimentSpec built from plain fields with ``pkg``'s own
    classes (``J``: the JAX package's runner, ``T``: the port's)."""
    ours = pkg is T
    WS = WorkloadSpec if ours else JWorkloadSpec
    EC = EngineConfig if ours else JEngineConfig
    AC = AutoscalerConfig if ours else JAutoscalerConfig
    cl = dict(cluster or {})
    if autoscaler is not None:
        cl.update(autoscale=True, autoscaler_cfg=AC(**autoscaler))
    return pkg.ExperimentSpec(
        scheduler=scheduler, workload=WS(**workload),
        engine=EC(**(engine or {})), cluster=pkg.ClusterSpec(**cl),
        warmup=warmup,
        telemetry=pkg.TelemetrySpec(metrics_out=metrics_out))


def _row(fs):
    return json.dumps(fs.row(), sort_keys=True)


def _same_fleet(**fields):
    j = J.run_cluster(_exp(J, **fields))
    t = T.run_cluster(_exp(T, **fields))
    assert _row(t) == _row(j)
    assert t.routed == j.routed
    assert t.replica_timeline == j.replica_timeline
    assert {r: s.row() for r, s in t.per_replica.items()} == \
        {r: s.row() for r, s in j.per_replica.items()}
    return t


def test_router_registries_match():
    assert list(ROUTERS) == list(JROUTERS)


@pytest.mark.parametrize("router", list(JROUTERS))
def test_every_router_matches_the_reference(router):
    f = _same_fleet(cluster=dict(router=router, n_replicas=2))
    assert sum(f.routed.values()) > 0


def test_disaggregated_fleet_matches_the_reference():
    """1 prefill + 1 decode under the disagg router: live migrations
    happen, conserve requests, and the row equals the reference's."""
    f = _same_fleet(scheduler="vllm", workload=CONTENDED,
                    cluster=dict(router="disagg",
                                 roles=["prefill", "decode"]))
    assert f.fleet.migrated_in == f.fleet.migrated_out > 0
    assert f.fleet.n_finished + f.fleet.n_shed + f.fleet.n_unfinished \
        == f.fleet.n_admitted


def test_roles_are_inert_under_other_routers():
    f = _same_fleet(cluster=dict(router="round-robin",
                                 roles=["prefill", "decode"]))
    assert f.fleet.migrated_in == f.fleet.migrated_out == 0


def test_autoscaler_matches_the_reference():
    f = _same_fleet(workload=RAMP, autoscaler=AUTOSCALE,
                    cluster=dict(router="slo-margin", n_replicas=1))
    # the ramp grows the fleet, and it drains back as the ramp falls
    assert f.n_replicas_peak > 1 and f.replica_timeline[-1][1] == 1


@pytest.mark.parametrize("fields", [
    dict(cluster=dict(router="slo-margin", n_replicas=3, vectorized=False)),
    dict(workload=TENANTED, cluster=dict(router="tenant", n_replicas=2)),
    dict(scheduler="gmg", cluster=dict(router="slo-margin", n_replicas=2)),
    dict(engine=dict(tp=2), cluster=dict(router="jsq", n_replicas=2)),
], ids=["scan-loop", "tenants", "gmg", "sim-tp2"])
def test_fleet_options_match_the_reference(fields):
    _same_fleet(**fields)


def test_legacy_shims_warn_and_match_the_reference():
    kw = dict(spec=WorkloadSpec(**SMALL), warmup=32, router="jsq",
              n_replicas=2)
    jkw = dict(kw, spec=JWorkloadSpec(**SMALL))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = T.run_cluster_experiment("tempo", **kw)
        single = T.run_experiment("tempo", spec=kw["spec"], warmup=32)
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = J.run_cluster_experiment("tempo", **jkw)
        ref_single = J.run_experiment("tempo", spec=jkw["spec"], warmup=32)
    assert _row(legacy) == _row(ref)
    assert _row(single) == _row(ref_single)


def test_from_kwargs_attaches_a_cluster_and_rejects_unknown():
    exp = T.ExperimentSpec.from_kwargs("gmg", warmup=32, router="tenant",
                                       n_replicas=3, backend_sink=[])
    assert exp.cluster.router == "tenant" and exp.cluster.n_replicas == 3
    assert exp.backend.sink == [] and exp.warmup == 32
    assert T.ExperimentSpec.from_kwargs("tempo").cluster is None
    with pytest.raises(TypeError, match="unknown experiment kwarg"):
        T.ExperimentSpec.from_kwargs("tempo", not_a_kwarg=1)


def test_run_refuses_a_cluster_and_the_fleet_refuses_tp():
    with pytest.raises(ValueError, match="use run_cluster"):
        T.run(T.ExperimentSpec(cluster=T.ClusterSpec()))
    # tensor-parallel replicas are ported (tests/test_torch_tp.py); a tp
    # degree the replicas' devices cannot hold is refused before any rank
    # starts
    with pytest.raises(ValueError, match="needs 2 devices"):
        T.run_cluster(T.ExperimentSpec(
            engine=EngineConfig(tp=2),
            backend=T.BackendSpec(kind="torch",
                                  kwargs=dict(devices=["cpu"])),
            cluster=T.ClusterSpec()))


def test_telemetry_report_matches_the_reference(tmp_path):
    """``metrics_out`` on a fleet: the port's dump and its dashboard (a
    verbatim copy) give the reference's report for the same run."""
    from repro.launch.dashboard import render_report as j_render
    from repro_torch.launch.dashboard import _load_dir, write_report

    fields = dict(cluster=dict(router="slo-margin", n_replicas=2))
    j = J.run_cluster(_exp(J, metrics_out=str(tmp_path / "j"), **fields))
    t = T.run_cluster(_exp(T, metrics_out=str(tmp_path / "t"), **fields))
    assert _row(t) == _row(j)
    path = write_report(str(tmp_path / "t"), title="fleet")
    snap, summary = _load_dir(str(tmp_path / "t"))
    assert summary == json.loads(json.dumps(j.row()))
    with open(path) as f:
        assert f.read() == j_render(snap, summary, title="fleet")


# ---------------------------------------------------------------------------
# entry points on the sim backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("autoscale", [False, True],
                         ids=["every-router", "autoscale"])
def test_serve_cluster_example(autoscale, monkeypatch, capsys):
    """The example's fleets at a shorter duration, vllm replicas (no
    predictor to warm-start): every router serves, and the autoscaled
    fleet grows under the ramp."""
    from repro_torch.examples import serve_cluster

    duration = 12.0 if autoscale else 1.0
    monkeypatch.setattr(serve_cluster, "WorkloadSpec", lambda **kw:
                        WorkloadSpec(**dict(kw, duration=duration)))
    serve_cluster.main(["--scheduler", "vllm"]
                       + (["--autoscale"] if autoscale else []))
    lines = capsys.readouterr().out.splitlines()
    if autoscale:
        counts = [int(ln.split()[-1]) for ln in lines[2:]]
        assert lines[1].startswith("replica-count") and max(counts) > 1
    else:
        assert [ln.split()[0] for ln in lines[1:1 + len(ROUTERS)]] == \
            list(ROUTERS)


def test_agentic_pipeline_example_runs(capsys):
    from repro_torch.examples import agentic_pipeline

    agentic_pipeline.main(duration=10.0)
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()
            if "dags=" in ln] == ["sarathi", "autellix", "tempo"]
    assert "matcher history" in out


@pytest.mark.parametrize("argv", [
    ["--duration", "8", "--rate", "4"],
    ["--duration", "8", "--rate", "4", "--fail-at", "4"],
], ids=["sim", "failover"])
def test_launch_serve_matches_the_reference(argv, monkeypatch, capsys):
    import sys

    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve

    t_serve.main(argv)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    assert ours == capsys.readouterr().out
