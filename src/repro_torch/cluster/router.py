"""Cluster routers: which replica does an arriving request land on?

All policies dispatch collective DAGs **atomically** — every stage sibling
(and all later stages, which the replica's engine spawns locally) runs on
one replica, so ``CollectiveDag`` advancement never crosses replicas.  A
cross-replica stage handoff would need KV-less stage boundaries plus dag
state migration; the paper's DAGs are stage-barriered so the atomic policy
loses nothing and keeps the engine contract intact.

Policies (JITServe's grouped margin-goodput idea lifted to fleet level):

  round-robin  — arrival-order striping; the no-information baseline.
  jsq          — join-shortest-queue on live+queued request count.
  least-kv     — most free KV blocks first (prefill-heavy traffic lands
                 where paging pressure is lowest), queue-length tiebreak.
  slo-margin   — estimate, per replica, how much fleet goodput *margin*
                 admitting the work would burn: the shortfall of the new
                 request against its own SLO under the replica's current
                 backlog, plus the degradation it inflicts on the replica's
                 live deadline work.  Dispatch where the margin degrades
                 least.  Uses each replica's own SLOTracker speed profile,
                 so slow/hot replicas organically shed load.
  prefix-affinity — slo-margin plus session stickiness: a session's
                 follow-up turns go to the replica whose prefix cache
                 holds their history, unless that replica's backlog costs
                 more than the re-prefill the affinity saves.  (DAGs are
                 dispatched atomically by every policy, so agentic-chain
                 affinity is structural and needs no map.)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.service import ServiceModel
from repro_torch.core.slo_tracker import SLOTracker
from repro_torch.obs import NULL
from repro_torch.serving.request import ReqState, Request


class Router:
    """``route(kind, obj, replicas, now)`` -> chosen replica.

    ``kind`` is "r" (obj: Request) or "dag" (obj: (CollectiveDag, reqs));
    ``replicas`` are the routable (active, non-draining) replicas, never
    empty.  Implementations must be deterministic."""

    name = "base"
    # metrics registry handle (repro.obs), rebound by ClusterEngine
    obs = NULL

    def route(self, kind: str, obj, replicas: List, now: float):
        raise NotImplementedError

    def note_route(self, rep, kind: str, now: float) -> None:
        """Record one routing decision (ClusterEngine calls this after
        every route() so all policies share the counter)."""
        self.obs.counter("router_routed_total",
                         "arrivals routed, by policy/replica/kind",
                         policy=self.name, replica=rep.rid,
                         kind=kind).inc(t=now)

    # ------------------------------------------------------------------
    @staticmethod
    def item_requests(kind: str, obj) -> List[Request]:
        return [obj] if kind == "r" else list(obj[1])


class RoundRobinRouter(Router):
    name = "round-robin"

    def __init__(self):
        self._i = 0

    def route(self, kind: str, obj, replicas: List, now: float):
        rep = replicas[self._i % len(replicas)]
        self._i += 1
        return rep


class JoinShortestQueueRouter(Router):
    name = "jsq"

    def route(self, kind: str, obj, replicas: List, now: float):
        return min(replicas, key=lambda rep: (rep.queue_len(), rep.rid))


class LeastKVPressureRouter(Router):
    name = "least-kv"

    def route(self, kind: str, obj, replicas: List, now: float):
        # fraction first (pressure), then absolute mesh-wide headroom so a
        # heterogeneous fleet (e.g. mixed-tp jax replicas) prefers the
        # bigger aggregate pool at equal utilisation
        return min(replicas,
                   key=lambda rep: (rep.kv_used_frac(),
                                    -rep.kv_free_tokens(),
                                    rep.queue_len(), rep.rid))


# ---------------------------------------------------------------------------
class SLOMarginRouter(Router):
    """Dispatch where the estimated goodput margin degrades least.

    Each SLO class is routed by the resource that actually binds its margin:

      latency     — TBT/TTFT bind on decode-slot pressure, so streams are
                    balanced on the per-replica latency-stream census (live
                    + dispatched), not on total work.
      collective  — a DAG's load materialises over its whole multi-stage
                    lifetime, long after dispatch; instantaneous queue state
                    is stale by then and chasing it synchronises load waves.
                    DAGs are balanced on cumulative routed stage-work (long-
                    run weighted striping).
      throughput  — TTLT binds on backlog: expected wait plus the projected
                    margin loss (the new request's shortfall under this
                    replica's backlog + the degradation admitting it
                    inflicts on the replica's live deadline work), priced
                    via each replica's own SLOTracker speed profile.
    """

    name = "slo-margin"

    def __init__(self, service: Optional[ServiceModel] = None,
                 margin_cap: int = 64, route_alpha: float = 4.0,
                 gain_rate: float = 3000.0):
        self.service = service or ServiceModel()
        self._fallback = SLOTracker()   # speeds before a replica has steps
        self.margin_cap = margin_cap    # live requests examined per replica
        # sharper decay than the service model's alpha: goodput is binary at
        # the deadline, so routing should weight the cliff, not the tail
        self.route_alpha = route_alpha
        # converts margin loss (gain units) into equivalent seconds of
        # replica capacity, so it composes with the expected-wait signal:
        # burning G gain ~ wasting G/gain_rate seconds of useful service
        self.gain_rate = gain_rate
        self._dag_work: Dict[int, float] = {}   # rid -> routed stage-work

    # -- coarse router-side length estimate ----------------------------
    @staticmethod
    def _est_out(req: Request) -> float:
        """The router sees the same imprecise information the analyzer does:
        the noisy log-length hint (no oracle access to true_output_len)."""
        if req.pred_upper is not None:
            return float(req.pred_upper)
        hint = req.meta.get("hint")
        if hint is not None:
            return float(np.clip(math.expm1(hint), 8.0, 16384.0))
        return 256.0

    def _tracker(self, rep) -> SLOTracker:
        tr = getattr(rep.engine.sched, "tracker", None)
        return tr if tr is not None else self._fallback

    def _serve_time(self, tr: SLOTracker, req: Request) -> float:
        return tr.est_prefill_time(req.prefill_remaining) \
            + tr.est_decode_time(self._est_out(req))

    def _backlog(self, rep, tr: SLOTracker) -> Tuple[float, List[Request]]:
        """Estimated queueing delay the new work inherits: total remaining
        service of live AND not-yet-admitted (dispatched while the replica's
        clock lags) requests, spread over the decode slots.  Pending DAG
        events carry their full multi-stage work — a queued agent chain is
        ~n_stages× the work a queue-length count sees."""
        live = [r for r in rep.engine.requests.values()
                if r.state != ReqState.FINISHED]
        total = 0.0
        for r in live:
            rem = tr.est_remaining_time(r, self._est_out(r))
            if r.dag_id is not None:
                # in-flight DAGs still owe their unspawned stages; without
                # this, chain-heavy replicas look light and attract traffic
                stages_left = max(int(r.meta.get("n_stages", 1))
                                  - r.stage, 1)
                rem *= stages_left
            total += rem
        for kind, obj in rep.engine.pending_items():
            pend = self.item_requests(kind, obj)
            mult = max(int(pend[0].meta.get("n_stages", 1)), 1) \
                if kind == "dag" else 1
            total += mult * sum(self._serve_time(tr, r) for r in pend)
        slots = max(rep.engine.cfg.max_batch, 1)
        return total / slots, live

    def _shortfall(self, req: Request, est_ttlt: float) -> float:
        """Goodput margin burned if the request lands at est_ttlt: the gap
        between its max gain and the cliff-decayed projected gain."""
        if req.slo.kind == "none":
            return 0.0
        est_out = self._est_out(req)
        if req.slo.kind == "latency":
            budget = req.slo.ttft + req.slo.tbt * max(est_out - 1.0, 0.0)
        else:
            budget = max(req.deadline - req.arrival, 1e-3)
        full = self.service.w_in * req.prompt_len + self.service.w_out \
            * est_out
        if est_ttlt <= budget:
            return 0.0
        return full * (1.0 - (budget / est_ttlt) ** self.route_alpha)

    # -- per-class dispatch --------------------------------------------
    def _route_dag(self, reqs: List[Request], replicas: List):
        stages = max(int(reqs[0].meta.get("n_stages", 1)), 1)
        # weight by calibrated fleet speeds (any live tracker will do —
        # striping only needs consistent relative work estimates)
        tr = self._tracker(replicas[0])
        work = stages * sum(self._serve_time(tr, r) for r in reqs)
        rep = min(replicas,
                  key=lambda rp: (self._dag_work.get(rp.rid, 0.0), rp.rid))
        self._dag_work[rep.rid] = self._dag_work.get(rep.rid, 0.0) + work
        return rep

    def _latency_census(self, rep) -> int:
        n = sum(1 for r in rep.engine.requests.values()
                if r.state != ReqState.FINISHED
                and r.slo.kind == "latency")
        for kind, obj in rep.engine.pending_items():
            n += sum(1 for r in self.item_requests(kind, obj)
                     if r.slo.kind == "latency")
        return n

    def route(self, kind: str, obj, replicas: List, now: float):
        reqs = self.item_requests(kind, obj)
        if kind == "dag":
            return self._route_dag(reqs, replicas)
        if reqs[0].slo.kind == "latency":
            return min(replicas,
                       key=lambda rep: (self._latency_census(rep), rep.rid))
        stages = 1
        best, best_key = None, None
        for rep in replicas:
            tr = self._tracker(rep)
            wait, live = self._backlog(rep, tr)
            serve = sum(self._serve_time(tr, r) for r in reqs) * stages
            # new work: shortfall against its own SLO under this backlog
            cost = sum(
                self._shortfall(r, (now - r.arrival) + wait
                                + self._serve_time(tr, r) * stages)
                for r in reqs)
            # existing work: admitting `serve` seconds of tokens delays the
            # replica's live deadline work by ~serve/slots each.
            delay = serve / max(rep.engine.cfg.max_batch, 1)
            # margin_summary is recomputed inside schedule(), which stops
            # running once a replica drains — the LIVENESS gate (not a
            # timestamp: replica clocks legitimately lag the fleet clock
            # in the co-simulation) is what keeps stale late/critical
            # counts from penalising an idle replica forever; the
            # summary's "t"/"lateness" fields are diagnostic
            ms = getattr(rep.engine.sched, "margin_summary", None)
            if ms is not None and live:
                # the scheduler already grouped its requests by SLO margin
                # (gmg): consume the group census instead of re-deriving
                # slack request-by-request.  Tight requests (late/critical)
                # have no margin to absorb the added delay — each eats it
                # in full; on-track/slack absorb it for free.
                counts = ms["counts"]
                tight = counts.get("late", 0) + counts.get("critical", 0)
                key = (wait + cost / self.gain_rate + delay * tight,
                       rep.rid)
            else:
                # schedulers without margin groups: stride-sample the live
                # set and price the inflicted degradation.  Truncating
                # would make the MOST loaded replica look cheapest, a
                # herding feedback loop — rescale instead.
                live_slo = [r for r in live if r.slo.kind != "none"]
                stride = max(1, -(-len(live_slo) // self.margin_cap))
                sample = live_slo[::stride]
                scale = len(live_slo) / max(len(sample), 1)
                deg = 0.0
                for r in sample:
                    base = (now - r.arrival) + tr.est_remaining_time(
                        r, self._est_out(r))
                    deg += self._shortfall(r, base + delay) \
                        - self._shortfall(r, base)
                cost += scale * deg
                # expected wait is the base load signal; margin loss is a
                # correction in capacity-seconds.  A pure margin score
                # would herd every arrival onto the first zero-cost
                # replica whenever no deadline binds anywhere.
                key = (wait + cost / self.gain_rate, rep.rid)
            if best is None or key < best_key:
                best, best_key = rep, key
        return best


# ---------------------------------------------------------------------------
class PrefixAffinityRouter(SLOMarginRouter):
    """Session follow-ups go to the replica that holds their KV prefix.

    Stickiness is load-balanced against the slo-margin backlog signal with
    hysteresis: the home replica keeps the session unless its expected
    wait exceeds ``stick_ratio`` × the lightest replica's plus the prefill
    time the cached prefix could possibly save (an upper bound — the whole
    prompt) and a small floor — ordinary load jitter never thrashes a
    session between caches, genuine hot-spotting sheds it.  First-turn
    (and identity-less) traffic routes exactly like slo-margin, which also
    seeds the affinity map."""

    name = "prefix-affinity"

    def __init__(self, service: Optional[ServiceModel] = None,
                 min_stick_s: float = 2.0, stick_ratio: float = 2.0,
                 max_sessions: int = 65536, **kw):
        # min_stick_s is deliberately coarse: a session streams for tens
        # of seconds, so backlog gaps shorter-lived than that are noise —
        # chasing them would synchronise migration waves (herding), the
        # exact failure mode the slo-margin backlog signal exists to avoid
        super().__init__(service=service, **kw)
        self.min_stick_s = min_stick_s
        self.stick_ratio = stick_ratio
        self.max_sessions = max_sessions
        self._home: Dict[int, int] = {}        # session_id -> replica rid

    def _remember(self, sid: int, rid: int) -> None:
        # bounded map: sessions end silently, so evict oldest-remembered
        # entries (insertion order) rather than growing forever
        if sid not in self._home and len(self._home) >= self.max_sessions:
            del self._home[next(iter(self._home))]
        self._home[sid] = rid

    def route(self, kind: str, obj, replicas: List, now: float):
        sid = obj.session_id if kind == "r" else None
        if sid is None:
            return super().route(kind, obj, replicas, now)
        by_rid = {rep.rid: rep for rep in replicas}
        home = by_rid.get(self._home.get(sid, -1))
        if home is None:                       # first turn / home drained
            rep = super().route(kind, obj, replicas, now)
            self._remember(sid, rep.rid)
            return rep
        waits = {rep.rid: self._backlog(rep, self._tracker(rep))[0]
                 for rep in replicas}
        lightest = min(replicas, key=lambda rp: (waits[rp.rid], rp.rid))
        saved = self._tracker(home).est_prefill_time(obj.prompt_len)
        if waits[home.rid] > self.stick_ratio * waits[lightest.rid] \
                + max(saved, self.min_stick_s):
            self._remember(sid, lightest.rid)  # cache cheaper to rebuild
            return lightest
        return home


# ---------------------------------------------------------------------------
class DisaggRouter(SLOMarginRouter):
    """Role-aware dispatch for a disaggregated fleet (DESIGN.md §12).

    Arrivals: fresh singles land on PREFILL-capable replicas (prefill or
    mixed) picked by the slo-margin signal; DAGs — dispatched atomically
    and never migrated — land on DECODE-capable replicas, keeping the
    pure-prefill pools free for migratable work (a DAG landing on any
    replica still prefills there: roles are soft).  Either preference
    falls back to the whole fleet when no replica of the wanted role is
    active (e.g. every mixed replica got flipped).

    Handoffs: when a prefill replica completes a prompt, the cluster asks
    ``choose_decode_target`` for a decode replica.  Each candidate is
    priced as transfer time (bytes over the backend's interconnect,
    computed by the caller from the StepCostModel's KV geometry) plus its
    backlog wait, plus — when the destination scheduler publishes a GMG
    margin census — a penalty per tight (late/critical) request the
    landing stream would delay.  Migration is declined (decode stays
    local, the TTFT fallback) when even the cheapest candidate would push
    the request's first token past its TTFT budget while staying local
    would not."""

    name = "disagg"

    @staticmethod
    def _by_role(replicas: List, roles: Tuple[str, ...]) -> List:
        sub = [rp for rp in replicas
               if getattr(rp.engine.cfg, "role", "mixed") in roles]
        return sub or replicas

    def route(self, kind: str, obj, replicas: List, now: float):
        roles = ("decode", "mixed") if kind == "dag" \
            else ("prefill", "mixed")
        return super().route(kind, obj, self._by_role(replicas, roles), now)

    def choose_decode_target(self, req: Request, source, replicas: List,
                             now: float, t_xfer: float):
        """Destination for a prefill-complete request, or None to decode
        locally.  Deterministic: ties break on replica id."""
        cands = [rp for rp in replicas if rp is not source
                 and getattr(rp.engine.cfg, "role", "mixed") != "prefill"]
        if not cands:
            return None
        best, best_cost = None, None
        for rp in cands:
            tr = self._tracker(rp)
            wait, live = self._backlog(rp, tr)
            cost = t_xfer + wait
            ms = getattr(rp.engine.sched, "margin_summary", None)
            if ms is not None and live:
                counts = ms["counts"]
                tight = counts.get("late", 0) + counts.get("critical", 0)
                # the landing stream delays each tight request by roughly
                # one slot-share of its own remaining decode service
                cost += tight * tr.est_decode_time(self._est_out(req)) \
                    / max(rp.engine.cfg.max_batch, 1)
            if best is None or (cost, rp.rid) < best_cost:
                best, best_cost = rp, (cost, rp.rid)
        if req.slo.kind == "latency" and req.first_token_t is None:
            src_tr = self._tracker(source)
            elapsed = now - req.arrival
            step = src_tr.est_decode_time(1.0)
            local_wait = self._backlog(source, src_tr)[0]
            if elapsed + best_cost[0] + step > req.slo.ttft \
                    and elapsed + local_wait + step <= req.slo.ttft:
                return None
        return best


# ---------------------------------------------------------------------------
class TenantWeightedRouter(SLOMarginRouter):
    """slo-margin with multi-tenant SLO classes priced in (DESIGN.md §13).

    Every margin-burn estimate — the arriving request's own shortfall AND
    the degradation admitting it inflicts on live deadline work — is
    multiplied by the request's tenant fairness weight
    (``meta['tenant_weight']``, from workload.TENANT_WEIGHT).  The fleet
    therefore optimises *weighted* goodput: an enterprise stream's margin
    is worth 4× a free stream's, so enterprise arrivals claim the replica
    that genuinely protects their SLO while free traffic is placed mostly
    by expected wait, and replicas holding enterprise backlogs repel
    low-value load first.  Untenanted requests weigh 1.0, so on an
    untenanted workload this routes identically to slo-margin."""

    name = "tenant"

    def _shortfall(self, req: Request, est_ttlt: float) -> float:
        w = float(req.meta.get("tenant_weight", 1.0))
        return w * super()._shortfall(req, est_ttlt)

    def route(self, kind: str, obj, replicas: List, now: float):
        rep = super().route(kind, obj, replicas, now)
        r0 = self.item_requests(kind, obj)[0]
        if r0.tenant:
            self.obs.counter("router_tenant_routed_total",
                             "arrivals routed, by tenant class",
                             tenant=r0.tenant).inc(t=now)
        return rep


ROUTERS = {
    "round-robin": RoundRobinRouter,
    "jsq": JoinShortestQueueRouter,
    "least-kv": LeastKVPressureRouter,
    "slo-margin": SLOMarginRouter,
    "prefix-affinity": PrefixAffinityRouter,
    "disagg": DisaggRouter,
    "tenant": TenantWeightedRouter,
}


def make_router(name: str, **kw) -> Router:
    if name not in ROUTERS:
        raise ValueError(f"unknown router {name!r}; "
                         f"choose from {sorted(ROUTERS)}")
    return ROUTERS[name](**kw)
