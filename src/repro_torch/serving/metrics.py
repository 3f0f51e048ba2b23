"""Metrics: service gain (total & timeline), SLO goodput, per-type latency
percentiles, throughput — everything the paper's figures report — plus
fleet-level aggregation for cluster runs (per-replica breakdown and the
replica-count timeline)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.service import ServiceModel
from repro_torch.serving.request import Request


def _pctl(xs: Sequence[float], p: float) -> Optional[float]:
    """Percentile, or None when there are no samples.  None (JSON null)
    rather than NaN: NaN poisons JSON round-trips and baseline
    comparisons — ``benchmarks/check.py`` treats null/absent percentile
    cells as "no samples", never as a regression."""
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs), p))


def _round(x: Optional[float], nd: int) -> Optional[float]:
    return None if x is None else round(x, nd)


@dataclasses.dataclass
class Summary:
    scheduler: str
    n_finished: int
    service_gain: float
    max_gain: float
    goodput_rps: float
    goodput_frac: float
    throughput_tok_s: float
    makespan: float
    per_type: Dict[str, Dict[str, float]]
    gain_timeline: List[float]      # per-bucket service gain
    preemptions: int = 0
    # honest denominators: goodput_frac is met / n_admitted, so a request
    # that was shed (dropped by the scheduler) or never finished (run
    # truncated, replica retired) counts as an SLO miss instead of
    # silently vanishing from the metric
    n_admitted: int = 0             # every request admitted to an engine
    n_shed: int = 0                 # ... dropped via Decision.shed
    @property
    def n_unfinished(self) -> int:
        return max(self.n_admitted - self.n_finished, 0)
    # prefix-cache accounting (engine counters; zeros when cache off or no
    # request carried a prefix identity)
    prefill_tokens: int = 0         # prompt tokens actually computed
    cached_tokens: int = 0          # prompt tokens served from cache
    prefix_hits: int = 0
    prefix_lookups: int = 0
    # scheduler/engine telemetry roll-ups (PR 6): JIT deferral
    # transitions, margin-refresh quanta (gmg; zero for other
    # schedulers), and the StepCostModel's |prediction − actual| step-time
    # residual percentiles (None until the model has fitted)
    deferrals: int = 0
    quanta: int = 0
    cost_residual_p50: Optional[float] = None
    cost_residual_p95: Optional[float] = None
    # speculative decoding (PR 8): draft tokens scored by verification and
    # the subset that matched the target's own samples; zeros spec-off
    spec_proposed: int = 0
    spec_accepted: int = 0
    # live KV migration (DESIGN.md §12): requests handed off after prefill
    # / landed for decode.  A migrated request counts ONCE fleet-wide —
    # the source drops it from its admitted set at handoff_out, the
    # destination counts it (and its tokens) at handoff_in, and the
    # destination's prefill_tokens never include the remotely-computed
    # prompt — these counters make the flow auditable per replica
    migrated_in: int = 0
    migrated_out: int = 0
    # multi-tenant SLO classes (DESIGN.md §13): per-tenant goodput /
    # attainment breakdown, keyed by tenant class.  Empty for untenanted
    # workloads.  Denominators are honest per-tenant submitted counts
    # (quota-shed and never-finished requests count as misses).
    per_tenant: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)

    @property
    def accept_rate(self) -> float:
        """Draft accept rate across the run (0.0 when spec was off)."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)

    @property
    def cached_frac(self) -> float:
        """Fraction of prompt tokens that came from the prefix cache."""
        return self.cached_tokens \
            / max(self.cached_tokens + self.prefill_tokens, 1)

    def row(self) -> Dict[str, float]:
        r = dict(scheduler=self.scheduler, n=self.n_finished,
                    n_admitted=self.n_admitted,
                    n_unfinished=self.n_unfinished, n_shed=self.n_shed,
                    service_gain=round(self.service_gain, 1),
                    gain_frac=round(self.service_gain / max(self.max_gain, 1e-9), 4),
                    goodput_rps=round(self.goodput_rps, 3),
                    goodput_frac=round(self.goodput_frac, 4),
                    tok_s=round(self.throughput_tok_s, 1),
                    # duplicate under the canonical name the decode-speed
                    # bench reports; tok_s stays for baseline-file compat
                    tok_per_s=round(self.throughput_tok_s, 1),
                    makespan=round(self.makespan, 1),
                    cached_frac=round(self.cached_frac, 4),
                    prefix_hit_rate=round(self.prefix_hit_rate, 4),
                    deferrals=self.deferrals, quanta=self.quanta,
                    resid_p50=_round(self.cost_residual_p50, 6),
                    resid_p95=_round(self.cost_residual_p95, 6),
                    accept_rate=round(self.accept_rate, 4),
                    migrated_in=self.migrated_in,
                    migrated_out=self.migrated_out)
        if self.per_tenant:
            r["per_tenant"] = self.per_tenant
        return r


def summarize(name: str, finished: List[Request], service: ServiceModel,
              makespan: float, bucket: float = 60.0,
              preemptions: int = 0,
              prefill_tokens: int = 0, cached_tokens: int = 0,
              prefix_hits: int = 0, prefix_lookups: int = 0,
              n_admitted: Optional[int] = None,
              shed: Optional[List[Request]] = None,
              deferrals: int = 0, quanta: int = 0,
              cost_residuals: Optional[Sequence[float]] = None,
              spec_proposed: int = 0, spec_accepted: int = 0,
              migrated_in: int = 0, migrated_out: int = 0,
              tenant_admitted: Optional[Dict[str, int]] = None) -> Summary:
    """Aggregate a run.  ``n_admitted`` is the count of requests the
    engine(s) admitted — shed and never-finished requests are (n_admitted
    − n_finished) and count as SLO misses in ``goodput_frac``.  Omitting
    it falls back to the finished count (pre-fix behaviour, correct only
    for fully-drained runs with no shedding).  ``shed`` requests
    contribute their partial realized gain (a dropped latency stream DID
    deliver tokens) and their max gain to the gain fraction."""
    shed = shed or []
    gain = sum(service.realized_gain(r) for r in finished) \
        + sum(service.realized_gain(r) for r in shed)
    maxg = sum(service.max_gain(r) for r in finished) \
        + sum(service.max_gain(r) for r in shed)
    met = [r for r in finished if service.slo_met(r)]
    # shed requests DID consume capacity (and fail their SLO): they are
    # part of the served population everywhere, not just the denominator.
    # Their token contribution is what was actually PROCESSED (prefilled,
    # possibly mid-prompt) — crediting the full prompt would inflate the
    # very throughput number this accounting exists to make honest.
    served = finished + shed
    toks = sum(r.prompt_len + r.decoded for r in finished) \
        + sum(r.prefilled + r.decoded for r in shed)
    mk = max(makespan, 1e-9)
    n_adm = n_admitted if n_admitted is not None else len(served)
    n_adm = max(n_adm, len(served))

    per_type: Dict[str, Dict[str, float]] = {}
    for kind in ("latency", "throughput", "collective", "none"):
        rs = [r for r in served if r.slo.kind == kind]
        if not rs:
            continue
        ttfts = [r.ttft() for r in rs if r.ttft() is not None]
        tbts = [t for r in rs for t in r.tbts()]
        ttlts = [r.ttlt() for r in rs if r.ttlt() is not None]
        per_type[kind] = dict(
            n=len(rs),
            ttft_p50=_pctl(ttfts, 50), ttft_p95=_pctl(ttfts, 95),
            tbt_p50=_pctl(tbts, 50), tbt_p95=_pctl(tbts, 95),
            ttlt_p50=_pctl(ttlts, 50), ttlt_p95=_pctl(ttlts, 95),
            slo_met=len([r for r in rs if service.slo_met(r)]) / len(rs),
        )

    # per-tenant goodput/attainment (empty for untenanted workloads).
    # slo_met mirrors per_type (attainment over the served population);
    # goodput_frac uses the honest per-tenant submitted denominator when
    # the engine provided one.
    per_tenant: Dict[str, Dict[str, float]] = {}
    t_adm = {k: v for k, v in (tenant_admitted or {}).items() if k}
    for tn in sorted({r.tenant for r in served if r.tenant} | set(t_adm)):
        fin_t = [r for r in finished if r.tenant == tn]
        shed_t = [r for r in shed if r.tenant == tn]
        rs = fin_t + shed_t
        met_t = len([r for r in fin_t if service.slo_met(r)])
        maxg_t = sum(service.max_gain(r) for r in rs)
        gain_t = sum(service.realized_gain(r) for r in rs)
        adm_t = max(t_adm.get(tn, 0), len(rs))
        per_tenant[tn] = dict(
            n=len(fin_t), n_shed=len(shed_t), n_admitted=adm_t,
            slo_met=round(met_t / max(len(rs), 1), 4),
            goodput_frac=round(met_t / max(adm_t, 1), 4),
            gain_frac=round(gain_t / max(maxg_t, 1e-9), 4))

    nb = int(mk // bucket) + 1
    timeline = [0.0] * nb
    for r in finished:
        if r.finish_t is not None:
            timeline[min(int(r.finish_t // bucket), nb - 1)] += \
                service.realized_gain(r)

    resid_abs = [abs(x) for x in (cost_residuals or ())]
    return Summary(
        scheduler=name, n_finished=len(finished), service_gain=gain,
        max_gain=maxg, goodput_rps=len(met) / mk,
        goodput_frac=len(met) / max(n_adm, 1),
        throughput_tok_s=toks / mk, makespan=mk, per_type=per_type,
        gain_timeline=timeline, preemptions=preemptions,
        n_admitted=n_adm, n_shed=len(shed),
        prefill_tokens=prefill_tokens, cached_tokens=cached_tokens,
        prefix_hits=prefix_hits, prefix_lookups=prefix_lookups,
        deferrals=deferrals, quanta=quanta,
        cost_residual_p50=_pctl(resid_abs, 50),
        cost_residual_p95=_pctl(resid_abs, 95),
        spec_proposed=spec_proposed, spec_accepted=spec_accepted,
        migrated_in=migrated_in, migrated_out=migrated_out,
        per_tenant=per_tenant)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetSummary:
    """Cluster-level rollup: the fleet-wide Summary plus the per-replica
    breakdown and the autoscaler's replica-count timeline."""
    router: str
    fleet: Summary
    per_replica: Dict[int, Summary]
    replica_timeline: List[Tuple[float, int]]   # (t, n_active) on change
    routed: Dict[int, int]                      # requests routed per replica
    # event-loop wall-time by phase (select/route/step/...) when the
    # cluster ran with profile=True; None otherwise (DESIGN.md §13)
    profile: Optional[Dict[str, float]] = None

    @property
    def goodput_frac(self) -> float:
        return self.fleet.goodput_frac

    @property
    def n_replicas_peak(self) -> int:
        return max(n for _, n in self.replica_timeline)

    def row(self) -> Dict[str, float]:
        r = self.fleet.row()
        r["router"] = self.router
        r["replicas_peak"] = self.n_replicas_peak
        r["replicas_final"] = self.replica_timeline[-1][1]
        return r


def summarize_fleet(router: str, scheduler: str,
                    finished_by_replica: Dict[int, List[Request]],
                    service: ServiceModel, makespan: float,
                    replica_timeline: Optional[
                        List[Tuple[float, int]]] = None,
                    routed: Optional[Dict[int, int]] = None,
                    preemptions: int = 0,
                    preempt_by_replica: Optional[Dict[int, int]] = None,
                    prefix_by_replica: Optional[
                        Dict[int, Tuple[int, int, int, int]]] = None,
                    admitted_by_replica: Optional[Dict[int, int]] = None,
                    shed_by_replica: Optional[
                        Dict[int, List[Request]]] = None,
                    deferrals_by_replica: Optional[Dict[int, int]] = None,
                    quanta_by_replica: Optional[Dict[int, int]] = None,
                    residuals_by_replica: Optional[
                        Dict[int, Sequence[float]]] = None,
                    spec_by_replica: Optional[
                        Dict[int, Tuple[int, int]]] = None,
                    migrated_by_replica: Optional[
                        Dict[int, Tuple[int, int]]] = None,
                    tenants_by_replica: Optional[
                        Dict[int, Dict[str, int]]] = None
                    ) -> FleetSummary:
    all_fin: List[Request] = [r for fin in finished_by_replica.values()
                              for r in fin]
    # per-replica (prefill_tokens, cached_tokens, hits, lookups) sums to
    # the fleet-wide prefix-cache stats
    pfx = prefix_by_replica or {}
    tot = [sum(v[i] for v in pfx.values()) for i in range(4)] \
        if pfx else [0, 0, 0, 0]
    adm = admitted_by_replica or {}
    shd = shed_by_replica or {}
    dfr = deferrals_by_replica or {}
    qta = quanta_by_replica or {}
    rsd = residuals_by_replica or {}
    spc = spec_by_replica or {}
    mig = migrated_by_replica or {}
    tnt = tenants_by_replica or {}
    tnt_fleet: Dict[str, int] = {}
    for d in tnt.values():
        for k, v in d.items():
            tnt_fleet[k] = tnt_fleet.get(k, 0) + v
    all_resid: List[float] = [x for rs in rsd.values() for x in rs]
    all_shed: List[Request] = [r for s in shd.values() for r in s]
    fleet = summarize(f"{scheduler}@{router}", all_fin, service, makespan,
                      preemptions=preemptions,
                      prefill_tokens=tot[0], cached_tokens=tot[1],
                      prefix_hits=tot[2], prefix_lookups=tot[3],
                      n_admitted=sum(adm.values()) if adm else None,
                      shed=all_shed,
                      deferrals=sum(dfr.values()), quanta=sum(qta.values()),
                      cost_residuals=all_resid,
                      spec_proposed=sum(v[0] for v in spc.values()),
                      spec_accepted=sum(v[1] for v in spc.values()),
                      migrated_in=sum(v[0] for v in mig.values()),
                      migrated_out=sum(v[1] for v in mig.values()),
                      tenant_admitted=tnt_fleet or None)
    pbr = preempt_by_replica or {}
    per_replica = {
        rid: summarize(f"{scheduler}@{router}/r{rid}", fin, service,
                       makespan, preemptions=pbr.get(rid, 0),
                       n_admitted=adm.get(rid),
                       shed=shd.get(rid),
                       deferrals=dfr.get(rid, 0), quanta=qta.get(rid, 0),
                       cost_residuals=rsd.get(rid),
                       spec_proposed=spc.get(rid, (0, 0))[0],
                       spec_accepted=spc.get(rid, (0, 0))[1],
                       migrated_in=mig.get(rid, (0, 0))[0],
                       migrated_out=mig.get(rid, (0, 0))[1],
                       tenant_admitted=tnt.get(rid),
                       **dict(zip(("prefill_tokens", "cached_tokens",
                                   "prefix_hits", "prefix_lookups"),
                                  pfx.get(rid, (0, 0, 0, 0)))))
        for rid, fin in finished_by_replica.items()}
    return FleetSummary(
        router=router, fleet=fleet, per_replica=per_replica,
        replica_timeline=replica_timeline or [(0.0,
                                               len(finished_by_replica))],
        routed=routed or {})
