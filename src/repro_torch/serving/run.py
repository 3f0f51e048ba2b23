"""One-call experiment runner: ``run(ExperimentSpec)`` -> Summary, for a
single replica.

``ExperimentSpec`` composes the workload, engine, backend and telemetry
sub-configs.  ``BackendSpec.kind`` selects the execution substrate: "sim"
(the roofline step-time model, default), "torch" (real decoding on a paged
device KV cache via ``PagedTorchBackend``; size the workload with
``WorkloadSpec.prompt_cap``/``output_cap`` so sequences fit the pool), or
any ``Backend`` instance.  ``ExperimentSpec.prompts`` may supply the
prompt tokens of the workload's requests (else the backend synthesizes
them from its seed and the rid).  Cluster runs are not ported: ``run``
refuses an ``ExperimentSpec`` whose ``cluster`` is set."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

from repro_torch.core.baselines import make_scheduler
from repro_torch.core.service import ServiceModel
from repro_torch.obs import MetricsRegistry, Tracer, dump_all
from repro_torch.serving.backend import Backend
from repro_torch.serving.engine import EngineConfig, ServeEngine, SimBackend
from repro_torch.serving.metrics import Summary, summarize
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
    None -> sim) and its constructor kwargs."""
    kind: Union[str, Backend, None] = None
    kwargs: Optional[Dict] = None


@dataclasses.dataclass
class TelemetrySpec:
    """Observability wiring.  ``metrics_out`` alone enables telemetry: a
    registry and tracer are created (unless passed in) and flushed to the
    directory as Prometheus text exposition, a JSON snapshot, trace JSONL,
    and a Chrome trace.  All three None is the zero-cost no-op path."""
    obs: Optional[MetricsRegistry] = None
    tracer: Optional[Tracer] = None
    metrics_out: Optional[str] = None


@dataclasses.dataclass
class ExperimentSpec:
    """One experiment: workload x scheduler x backend (x telemetry).
    ``cluster`` must stay None: fleet runs are not ported."""
    scheduler: str = "tempo"
    workload: Optional[WorkloadSpec] = None
    engine: Optional[EngineConfig] = None
    backend: BackendSpec = dataclasses.field(default_factory=BackendSpec)
    cluster: Optional[object] = None
    telemetry: TelemetrySpec = dataclasses.field(
        default_factory=TelemetrySpec)
    service: Optional[ServiceModel] = None
    warmup: int = 512               # predictor warm-start sample size
    sched_kwargs: Optional[Dict] = None
    # prompt tokens of each single request the workload generates (None:
    # synthesized by the backend); DAG stages spawn later and keep theirs
    prompts: Optional[Callable[[Request], Optional[Sequence[int]]]] = None

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


def run(exp: ExperimentSpec) -> Summary:
    """Single-replica experiment; ``exp.cluster`` must be None."""
    if exp.cluster is not None:
        raise ValueError("exp.cluster is set - cluster runs are not ported")
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
    if exp.prompts is not None:
        for r in singles:
            toks = exp.prompts(r)
            if toks is not None:
                r.meta["prompt_tokens"] = list(toks)
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
