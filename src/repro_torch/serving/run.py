"""One-call experiment runners: ``run(ExperimentSpec)`` -> Summary
(single replica) or ``run_cluster(ExperimentSpec)`` -> FleetSummary
(a fleet of replicas under a router, optionally autoscaled or
disaggregated into prefill and decode roles with live KV migration).

``ExperimentSpec`` composes the workload, engine, backend, cluster and
telemetry sub-configs.  ``BackendSpec.kind`` selects the execution
substrate: "sim" (the roofline step-time model, default), "torch" (real
decoding on a paged device KV cache via ``PagedTorchBackend``; size the
workload with ``WorkloadSpec.prompt_cap``/``output_cap`` so sequences fit
the pool), or any ``Backend`` instance.  ``ExperimentSpec.prompts`` may
supply the prompt tokens of the workload's single requests (else the
backend synthesizes them from its seed and the rid).  The legacy
``run_experiment`` / ``run_cluster_experiment`` signatures survive as
thin shims that emit a ``DeprecationWarning`` and delegate through
``ExperimentSpec.from_kwargs``."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.core.baselines import make_scheduler
from repro_torch.core.service import ServiceModel
from repro_torch.obs import MetricsRegistry, Tracer, dump_all
from repro_torch.serving.backend import Backend
from repro_torch.serving.engine import EngineConfig, ServeEngine, SimBackend
from repro_torch.serving.metrics import (FleetSummary, Summary, summarize,
                                         summarize_fleet)
from repro_torch.serving.request import Request
from repro_torch.serving.workload import WorkloadGen, WorkloadSpec


def _service_aware(scheduler: str) -> bool:
    """Schedulers whose ranking consumes the ServiceModel (gain/decay)."""
    return (scheduler.startswith("tempo") and scheduler != "tempo-sjf") \
        or scheduler.startswith("gmg")


def make_backend(backend: Union[str, Backend, None],
                 backend_kwargs: Optional[Dict] = None) -> Backend:
    """Resolve the backend axis: "sim" | "torch" | instance | None."""
    if backend is None or backend == "sim":
        kw = dict(backend_kwargs or {})
        kw.pop("tp", None)     # sim models its chips explicitly
        kw.pop("devices", None)
        return SimBackend.for_model(kw.pop("name", "llama-8b"), **kw)
    if backend == "torch":
        from repro_torch.serving.torch_backend import PagedTorchBackend
        return PagedTorchBackend(**(backend_kwargs or {}))
    if backend == "jax":
        raise ValueError("backend 'jax' belongs to the JAX package's runner "
                         "(repro.serving.run); this one serves sim | torch")
    if isinstance(backend, str):
        raise ValueError(f"unknown backend {backend!r} (sim | torch)")
    return backend


def _with_tp(backend, backend_kwargs: Optional[Dict],
             engine_cfg: EngineConfig) -> Optional[Dict]:
    """Thread EngineConfig.tp into the torch backend's kwargs (explicit
    backend_kwargs['tp'] wins)."""
    if backend != "torch" or engine_cfg.tp <= 1:
        return backend_kwargs
    kw = dict(backend_kwargs or {})
    kw.setdefault("tp", engine_cfg.tp)
    return kw


@dataclasses.dataclass
class BackendSpec:
    """Execution substrate: kind ("sim" | "torch" | Backend instance |
    None -> sim), constructor kwargs, an optional per-replica factory
    (cluster runs; overrides kind/kwargs), and an optional sink list that
    collects every backend the cluster runner builds (for fleet-wide
    token-stream digests)."""
    kind: Union[str, Backend, None] = None
    kwargs: Optional[Dict] = None
    factory: Optional[Callable[[int], Backend]] = None
    sink: Optional[List] = None


@dataclasses.dataclass
class ClusterSpec:
    """Fleet shape + cluster-only policies.  Present on an ExperimentSpec
    -> ``run_cluster``; absent (None) -> single-replica ``run``.
    ``vectorized``/``profile`` select the event-selection path and enable
    the phase-attributed event-loop profile."""
    router: Union[str, object] = "slo-margin"
    n_replicas: int = 2
    roles: Optional[List[str]] = None   # disaggregation: one per replica
    autoscale: bool = False
    autoscaler_cfg: Optional[object] = None
    vectorized: bool = True
    profile: bool = False


@dataclasses.dataclass
class TelemetrySpec:
    """Observability wiring.  ``metrics_out`` alone enables telemetry: a
    registry and tracer are created (unless passed in) and flushed to the
    directory as Prometheus text exposition, a JSON snapshot, trace JSONL,
    and a Chrome trace.  All three None is the zero-cost no-op path."""
    obs: Optional[MetricsRegistry] = None
    tracer: Optional[Tracer] = None
    metrics_out: Optional[str] = None


# legacy kwarg -> (sub-config attribute path) for from_kwargs
_LEGACY_MAP = {
    "spec": ("workload",), "engine_cfg": ("engine",),
    "service": ("service",), "warmup": ("warmup",),
    "sched_kwargs": ("sched_kwargs",),
    "backend": ("backend", "kind"), "backend_kwargs": ("backend", "kwargs"),
    "backend_factory": ("backend", "factory"),
    "backend_sink": ("backend", "sink"),
    "router": ("cluster", "router"), "n_replicas": ("cluster", "n_replicas"),
    "roles": ("cluster", "roles"), "autoscale": ("cluster", "autoscale"),
    "autoscaler_cfg": ("cluster", "autoscaler_cfg"),
    "vectorized": ("cluster", "vectorized"),
    "profile": ("cluster", "profile"),
    "obs": ("telemetry", "obs"), "tracer": ("telemetry", "tracer"),
    "metrics_out": ("telemetry", "metrics_out"),
}
_CLUSTER_KEYS = frozenset(k for k, path in _LEGACY_MAP.items()
                          if path[0] == "cluster")


@dataclasses.dataclass
class ExperimentSpec:
    """One experiment: workload x scheduler x backend (x fleet x
    telemetry).  ``cluster=None`` means single replica."""
    scheduler: str = "tempo"
    workload: Optional[WorkloadSpec] = None
    engine: Optional[EngineConfig] = None
    backend: BackendSpec = dataclasses.field(default_factory=BackendSpec)
    cluster: Optional[ClusterSpec] = None
    telemetry: TelemetrySpec = dataclasses.field(
        default_factory=TelemetrySpec)
    service: Optional[ServiceModel] = None
    warmup: int = 512               # predictor warm-start sample size
    sched_kwargs: Optional[Dict] = None
    # prompt tokens of each single request the workload generates (None:
    # synthesized by the backend); DAG stages spawn later and keep theirs
    prompts: Optional[Callable[[Request], Optional[Sequence[int]]]] = None

    @classmethod
    def from_kwargs(cls, scheduler: str = "tempo", *,
                    cluster: bool = False, **kw) -> "ExperimentSpec":
        """Build a spec from the legacy flat-kwarg vocabulary of
        ``run_experiment`` / ``run_cluster_experiment``.  ``cluster=True``
        (or any cluster-only kwarg) attaches a ClusterSpec."""
        exp = cls(scheduler=scheduler)
        if cluster or (_CLUSTER_KEYS & kw.keys()):
            exp.cluster = ClusterSpec()
        for k, v in kw.items():
            path = _LEGACY_MAP.get(k)
            if path is None:
                raise TypeError(f"unknown experiment kwarg {k!r}")
            if len(path) == 1:
                setattr(exp, path[0], v)
            else:
                setattr(getattr(exp, path[0]), path[1], v)
        return exp

    def resolved(self) -> "ExperimentSpec":
        """A copy with every None sub-config replaced by its default."""
        return dataclasses.replace(
            self,
            workload=self.workload or WorkloadSpec(),
            engine=self.engine or EngineConfig(),
            service=self.service or ServiceModel())


def _prep(exp: ExperimentSpec):
    """Resolve defaults, auto-create telemetry when metrics_out is set, and
    build the scheduler kwargs."""
    exp = exp.resolved()
    tel = exp.telemetry
    if tel.metrics_out:
        tel = dataclasses.replace(
            tel,
            obs=tel.obs if tel.obs is not None else MetricsRegistry(),
            tracer=tel.tracer if tel.tracer is not None else Tracer())
        exp = dataclasses.replace(exp, telemetry=tel)
    sk = dict(exp.sched_kwargs or {})
    if _service_aware(exp.scheduler):
        sk.setdefault("service", exp.service)
    return exp, sk


def _with_prompts(exp: ExperimentSpec, req: Request) -> Request:
    """Give a single request the prompt tokens ``exp.prompts`` names."""
    if exp.prompts is not None:
        toks = exp.prompts(req)
        if toks is not None:
            req.meta["prompt_tokens"] = list(toks)
    return req


# ---------------------------------------------------------------------------
def run(exp: ExperimentSpec) -> Summary:
    """Single-replica experiment; ``exp.cluster`` must be None."""
    if exp.cluster is not None:
        raise ValueError("exp.cluster is set - use run_cluster()")
    exp, sk = _prep(exp)
    tel = exp.telemetry
    backend = make_backend(exp.backend.kind,
                           _with_tp(exp.backend.kind, exp.backend.kwargs,
                                    exp.engine))
    sched = make_scheduler(exp.scheduler, **sk)

    gen = WorkloadGen(exp.workload)
    if exp.warmup and getattr(sched, "needs_predictions", False):
        pred = getattr(sched, "predictor", None)
        if pred is not None:
            pred.warm_start(gen.warmup_requests(exp.warmup))

    singles, dags = gen.generate()
    for r in singles:
        _with_prompts(exp, r)
    eng = ServeEngine(backend, sched, exp.engine, workload=gen,
                      obs=tel.obs, tracer=tel.tracer)
    eng.load(singles, dags)
    finished = eng.run()
    # the denominator counts everything submitted: admitted (finished,
    # live-at-truncation, shed), arrivals still queued when the run
    # ended, and unspawned DAG stages
    summ = summarize(sched.name if hasattr(sched, "name") else exp.scheduler,
                     finished, exp.service, eng.now,
                     preemptions=eng.preempt_count,
                     prefill_tokens=eng.prefill_computed,
                     cached_tokens=eng.cached_tokens,
                     prefix_hits=eng.prefix_hits,
                     prefix_lookups=eng.prefix_lookups,
                     n_admitted=eng.submitted_count, shed=eng.shed,
                     deferrals=getattr(sched, "n_deferrals", 0),
                     quanta=getattr(sched, "n_quanta", 0),
                     cost_residuals=eng.cost_residuals,
                     spec_proposed=eng.spec_proposed,
                     spec_accepted=eng.spec_accepted,
                     tenant_admitted=eng.tenant_submitted() or None)
    if tel.metrics_out:
        dump_all(tel.metrics_out, registry=tel.obs, tracer=tel.tracer,
                 extra=summ.row())
    return summ


# ---------------------------------------------------------------------------
def run_cluster(exp: ExperimentSpec) -> FleetSummary:
    """Serve one workload across a fleet (``exp.cluster`` required; a
    default ClusterSpec is attached when absent).

    Every replica gets its OWN scheduler, backend, EngineConfig copy, and
    KV pool; they share only the ``WorkloadGen`` (collective-DAG ground
    truth) and the arrival stream.  Real replicas run on the backend's
    device (``cuda`` unless the backend kwargs say ``device="cpu"``), one
    at a time from this thread, so kernel launches of two replicas never
    overlap.  Tensor-parallel replicas (``engine.tp > 1`` on the torch
    backend) each get a slice of ``tp`` CUDA devices, wrapping
    round-robin over the host's cards, as the reference's do; a host with
    fewer cards than ``tp`` gets no slice and the backend raises (ranks
    share a card only when the backend kwargs name ``devices``).

    ``cluster.roles`` disaggregates the fleet: one role per initial
    replica (overriding ``n_replicas`` to its length), e.g.
    ``["prefill", "decode"]``; pair with ``router="disagg"`` to get the
    migration path — other routers treat roles as inert metadata.
    ``backend.sink``, when a list, collects every replica backend the
    runner builds, so callers can digest real token streams fleet-wide
    after the run.  ``exp.prompts`` applies to single requests as in
    ``run``."""
    from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
    from repro_torch.cluster.engine import ClusterEngine
    from repro_torch.cluster.router import make_router

    if exp.cluster is None:
        exp = dataclasses.replace(exp, cluster=ClusterSpec())
    exp, base_sk = _prep(exp)
    cs, tel, bs = exp.cluster, exp.telemetry, exp.backend
    engine_cfg, service = exp.engine, exp.service
    n_replicas = len(cs.roles) if cs.roles else cs.n_replicas
    # every replica runs the SAME model: a fresh backend per replica (own
    # page pool / timers / generator), built from the same backend spec
    backend_factory = bs.factory
    if backend_factory is None:
        base_kw = _with_tp(bs.kind, bs.kwargs, engine_cfg)

        def backend_factory(rid: int):
            kw = base_kw
            tp = (base_kw or {}).get("tp", 1)
            if (bs.kind == "torch" and tp > 1 and "devices" not in base_kw
                    and base_kw.get("device") in (None, "cuda")):
                import torch
                n = torch.cuda.device_count()
                # distinct per replica, wrapping round-robin; with fewer
                # cards than tp pass nothing and let the backend raise
                if n >= tp:
                    kw = dict(base_kw, devices=[
                        f"cuda:{(rid * tp + i) % n}" for i in range(tp)])
            return make_backend(bs.kind, kw)
    if bs.sink is not None:
        _inner_bf = backend_factory

        def backend_factory(rid: int):            # noqa: F811
            b = _inner_bf(rid)
            bs.sink.append(b)
            return b

    gen = WorkloadGen(exp.workload)
    warm: List[List] = []       # generated once, on the first replica that
                                # needs predictor warm-start (own RNG, so a
                                # lazy mid-stream draw never perturbs the
                                # arrival stream)

    def replica_factory(rid: int) -> ServeEngine:
        sched = make_scheduler(exp.scheduler, **dict(base_sk))
        if exp.warmup and getattr(sched, "needs_predictions", False):
            pred = getattr(sched, "predictor", None)
            if pred is not None:
                if not warm:
                    warm.append(gen.warmup_requests(exp.warmup))
                pred.warm_start(warm[0])
        # each replica reports into a labeled view of the fleet registry
        # (one instrument per metric × replica) and the shared tracer
        cfg = dataclasses.replace(engine_cfg)
        if cs.roles and rid < len(cs.roles):
            cfg.role = cs.roles[rid]
        return ServeEngine(backend_factory(rid), sched, cfg, workload=gen,
                           obs=None if tel.obs is None
                           else tel.obs.labeled(replica=rid),
                           tracer=tel.tracer, replica=rid)

    if isinstance(cs.router, str):
        # a caller-supplied router INSTANCE keeps its own ServiceModel
        kw = {"service": service} \
            if cs.router in ("slo-margin", "prefix-affinity", "disagg",
                             "tenant") else {}
        rt = make_router(cs.router, **kw)
    else:
        rt = cs.router
    scaler = Autoscaler(cs.autoscaler_cfg or AutoscalerConfig(),
                        service=service) if cs.autoscale else None
    cluster = ClusterEngine(replica_factory, rt, n_replicas=n_replicas,
                            autoscaler=scaler, obs=tel.obs,
                            vectorized=cs.vectorized, profile=cs.profile)
    finished = cluster.run(_arrivals(exp, gen))
    reps = cluster.replicas
    fs = summarize_fleet(rt.name, exp.scheduler, finished, service,
                         cluster.makespan,
                         replica_timeline=cluster.replica_timeline,
                         routed=cluster.routed,
                         preemptions=cluster.preempt_count,
                         preempt_by_replica={
                             rep.rid: rep.engine.preempt_count
                             for rep in reps},
                         prefix_by_replica={
                             rep.rid: (rep.engine.prefill_computed,
                                       rep.engine.cached_tokens,
                                       rep.engine.prefix_hits,
                                       rep.engine.prefix_lookups)
                             for rep in reps},
                         admitted_by_replica={
                             rep.rid: rep.engine.submitted_count
                             for rep in reps},
                         shed_by_replica={
                             rep.rid: rep.engine.shed for rep in reps},
                         deferrals_by_replica={
                             rep.rid: getattr(rep.engine.sched,
                                              "n_deferrals", 0)
                             for rep in reps},
                         quanta_by_replica={
                             rep.rid: getattr(rep.engine.sched,
                                              "n_quanta", 0)
                             for rep in reps},
                         residuals_by_replica={
                             rep.rid: rep.engine.cost_residuals
                             for rep in reps},
                         spec_by_replica={
                             rep.rid: (rep.engine.spec_proposed,
                                       rep.engine.spec_accepted)
                             for rep in reps},
                         migrated_by_replica={
                             rep.rid: (rep.engine.migrated_in,
                                       rep.engine.migrated_out)
                             for rep in reps},
                         tenants_by_replica={
                             rep.rid: rep.engine.tenant_submitted()
                             for rep in reps})
    if cs.profile:
        fs.profile = dict(cluster.profile)
    if tel.metrics_out:
        dump_all(tel.metrics_out, registry=tel.obs, tracer=tel.tracer,
                 extra=fs.row())
    return fs


def _arrivals(exp: ExperimentSpec, gen: WorkloadGen) -> Iterator:
    """The workload's arrival stream, single requests given their
    ``exp.prompts`` tokens as they arrive."""
    for t, kind, obj in gen.arrival_stream():
        yield t, kind, _with_prompts(exp, obj) if kind == "r" else obj


# ---------------------------------------------------------------------------
# Legacy flat-kwarg shims (DeprecationWarning; delegate via from_kwargs)
# ---------------------------------------------------------------------------
def run_experiment(scheduler: str = "tempo", **kw) -> Summary:
    """Deprecated: build an ``ExperimentSpec`` and call ``run()``."""
    warnings.warn("run_experiment(**kwargs) is deprecated; build an "
                  "ExperimentSpec and call run()", DeprecationWarning,
                  stacklevel=2)
    return run(ExperimentSpec.from_kwargs(scheduler, **kw))


def run_cluster_experiment(scheduler: str = "tempo", **kw) -> FleetSummary:
    """Deprecated: build an ``ExperimentSpec`` (with a ``ClusterSpec``)
    and call ``run_cluster()``."""
    warnings.warn("run_cluster_experiment(**kwargs) is deprecated; build "
                  "an ExperimentSpec and call run_cluster()",
                  DeprecationWarning, stacklevel=2)
    return run_cluster(ExperimentSpec.from_kwargs(scheduler, cluster=True,
                                                  **kw))
