"""SLO-aware schedulers: the shared Request-Analyzer base, plus Tempo's
Largest Service Density First ranking (paper §4.2, Algorithm 1) with
cost-aware preemption, time-slicing quanta, a starvation reserve for
non-SLO traffic, and pluggable fairness mixing (§4.3).  The grouped-margin
goodput scheduler (paper §4's namesake algorithm) lives in ``core/gmg.py``
on top of the same base.

Engine contract (continuous batching with chunked prefill):
  every engine step the scheduler returns a ``Decision``:
    decode_ids  — requests that decode one token this step (≤ max_batch)
    prefill     — {rid: chunk_tokens} sharing the step's prefill token budget
    preempted   — requests displaced from their slot (KV stays resident)
    shed        — requests dropped outright (KV released, counted as SLO
                  misses by the metrics layer)

Density (Eq. 4):
            projected service gain under the (refined) estimates
  density = ---------------------------------------------------
            estimated remaining processing time

Collective requests share their stage's deadline; the stage's remaining time
is the max across stage siblings (finishing one early doesn't finish the
stage), so Tempo throttles short siblings and spares bandwidth — this is the
"just enough bandwidth" principle.  Latency requests are PACED: when they are
ahead of their TBT timeline they are deferred (near-zero urgency) and the
capacity goes to deadline work; when behind, their density spikes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.dag import DagMatcher, DagTracker, SuperGraph
from repro_torch.core.predictor import LengthPredictor
from repro_torch.obs import NULL as OBS_NULL, NULL_TRACER as TRACER_NULL
from repro_torch.core.service import ServiceModel
from repro_torch.core.slo_tracker import SLOTracker
from repro_torch.serving.kvcache import BLOCK_TOKENS, block_bytes
from repro_torch.serving.request import ReqState, Request


@dataclasses.dataclass
class Decision:
    decode_ids: List[int]
    prefill: Dict[int, int]
    preempted: List[int] = dataclasses.field(default_factory=list)
    shed: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineView:
    """What the engine exposes to schedulers each step."""
    now: float
    step: int
    requests: Dict[int, Request]          # all live requests
    max_batch: int                        # decode slots
    prefill_budget: int                   # tokens/step (chunked prefill)
    # block geometry — derived from the shared kvcache constants so the
    # preemption cost model can't silently disagree with the BlockManager
    kv_block_bytes: int = block_bytes()
    block_tokens: int = BLOCK_TOKENS
    swap_bw: float = 60e9                 # HBM<->host for preemption cost
    kv_free_frac: float = 1.0             # KV pool headroom
    dag_remaining: Optional[Callable] = None  # rid -> max sibling remaining


class SchedulerBase:
    name = "base"
    needs_predictions = False
    # telemetry handles (repro.obs), rebound by the owning ServeEngine so
    # scheduler instrumentation shares the run's registry/tracer; the
    # class-level defaults are the zero-cost disabled singletons
    obs = OBS_NULL
    tracer = TRACER_NULL
    replica = 0

    def on_arrival(self, req: Request, view: EngineView):  # pragma: no cover
        pass

    def on_finish(self, req: Request, view: EngineView):
        pass

    def schedule(self, view: EngineView) -> Decision:
        raise NotImplementedError

    def decode_horizon(self, view: EngineView) -> int:
        """How many decode micro-steps the engine may run in one dispatch
        before this scheduler needs to see the world again (DESIGN.md §10).
        The engine further caps this by arrivals, per-request remaining
        output, and KV headroom; schedulers with step-granular state
        (quanta, pacing) override to their next boundary.  The base class
        has no step-coupled state, so any horizon is safe."""
        return 1 << 10

    def spec_depth(self, view: EngineView) -> Dict[int, int]:
        """Per-request speculative draft depth for this step (DESIGN.md
        §11): {rid: max draft tokens to verify}.  An empty dict means "no
        opinion" — the engine grants its configured ceiling
        (``EngineConfig.spec_depth_max``) to every decode lane; a rid
        missing from a non-empty dict also falls back to the ceiling.  The
        engine further clamps every grant by the ceiling, the lane's
        remaining output, and KV headroom for the drafted window.
        Schedulers with SLO state override this to spend verification
        compute where the margin needs it (see GroupedMarginScheduler)."""
        return {}


# ---------------------------------------------------------------------------
# Shared Request-Analyzer machinery (Algorithm 1: AnalyzeRequest)
# ---------------------------------------------------------------------------
class AnalyzedSchedulerBase(SchedulerBase):
    """Everything Tempo, the oracle variant, and the grouped-margin
    scheduler have in common: QRF length-bound annotation at admission,
    online refinement as generation progresses, the DAG tracker hooks, the
    quanta-gated priority cache, and the cached priority ORDER — including
    the rule that freshly admitted requests become visible (and therefore
    prefill-eligible) immediately, not at the next quanta refresh.

    Subclasses implement ``_priority_raw`` (the ranking signal the cache
    stores) and ``schedule``.
    """

    needs_predictions = True

    def __init__(self, predictor: Optional[LengthPredictor] = None,
                 matcher: Optional[DagMatcher] = None,
                 tracker: Optional[SLOTracker] = None,
                 service: Optional[ServiceModel] = None,
                 *, precise: bool = False, use_graph: bool = True,
                 use_predictor: bool = True,
                 quanta: int = 20, refine_every: int = 32):
        self.predictor = predictor or LengthPredictor()
        self.matcher = matcher or DagMatcher()
        self.dag_tracker = DagTracker(self.matcher)
        self.tracker = tracker or SLOTracker()
        self.service = service or ServiceModel()
        self.precise = precise
        self.use_graph = use_graph
        self.use_predictor = use_predictor
        self.quanta = quanta
        self.refine_every = refine_every
        self._running: Set[int] = set()
        # priority cache (paper §5): recomputed on arrivals/finishes and at
        # quanta boundaries, not every engine step
        self._prio: Dict[int, float] = {}
        self._prio_step = -10**9
        self._dirty = True
        # arrivals since the last order rebuild: merged into the cached
        # order on the NEXT schedule() call so a new request never waits a
        # quanta (or the dirty+5 backoff) to start prefilling
        self._new_rids: List[int] = []
        self._order: Optional[List[int]] = None

    # ------------------------------------------------------------------
    def on_arrival(self, req: Request, view: EngineView):
        self._dirty = True
        self._new_rids.append(req.rid)
        if self.precise:
            req.pred_upper = float(req.true_output_len)
            req.pred_point = float(req.true_output_len)
        elif self.use_predictor:
            req.pred_upper = self.predictor.predict_upper(req)
            req.pred_point = self.predictor.predict_point(req)
        else:
            req.pred_upper = 4.0 * max(req.prompt_len, 256)
            req.pred_point = req.pred_upper / 4.0

    def on_finish(self, req: Request, view: EngineView):
        self._dirty = True
        if self.use_predictor and not self.precise:
            self.predictor.observe(req)
            # samples-since-last-fit counter, NOT a modulus on len(_y):
            # observe() appends 1-4 samples per request, so a modulus is
            # routinely stepped over and the QRF would never refit after
            # warm start (stale-predictor bug)
            self.predictor.maybe_fit()

    def refine(self, req: Request, view: EngineView):
        """Online refinement as generation progresses (§4.1)."""
        if self.precise:
            return
        if self.use_predictor and req.decoded > 0 and \
                req.decoded % self.refine_every == 0 and \
                req.meta.get("refined_at") != req.decoded:
            req.meta["refined_at"] = req.decoded
            req.pred_upper = self.predictor.predict_upper(req, req.decoded)

    # ------------------------------------------------------------------
    def _est_upper(self, req: Request) -> float:
        ub = req.pred_upper if req.pred_upper is not None else 512.0
        return max(ub, req.decoded + 1.0)

    def _priority_raw(self, req: Request, view: EngineView) -> float:
        raise NotImplementedError

    def decode_horizon(self, view: EngineView) -> int:
        """Multi-step dispatch may run at most to the next quanta boundary:
        priority refresh, membership changes, and preemption all happen
        there, so skipping past it would let a stale batch outlive its
        time slice."""
        return max(1, self.quanta - (view.step - self._prio_step))

    def _refresh_priorities(self, view: EngineView, reqs) -> None:
        stale = (view.step - self._prio_step) >= self.quanta
        if not stale and not (self._dirty and
                              (view.step - self._prio_step) >= 5):
            return
        self._prio = {r.rid: self._priority_raw(r, view) for r in reqs}
        self._prio_step = view.step
        self._dirty = False

    def _priority(self, req: Request, view: EngineView) -> float:
        p = self._prio.get(req.rid)
        if p is None:
            p = self._priority_raw(req, view)
            self._prio[req.rid] = p
        return p

    def _update_order(self, view: EngineView, reqs: Sequence[Request],
                      at_quanta: bool) -> List[int]:
        """Cached priority order over SLO-bearing requests.  Rebuilt at
        refresh boundaries — and whenever arrivals landed since, so fresh
        requests are schedulable (in particular: prefillable) on the very
        step after admission instead of stalling for up to 5 steps with
        idle budget."""
        if at_quanta or self._order is None:
            self._order = sorted(
                (r.rid for r in reqs if r.slo.kind != "none"),
                key=lambda rid: (-self._prio.get(rid, 0.0), rid))
            self._new_rids.clear()
        elif self._new_rids:
            for rid in self._new_rids:
                r = view.requests.get(rid)
                if r is not None and r.slo.kind != "none":
                    self._priority(r, view)       # compute + cache
            self._order = sorted(
                (r.rid for r in reqs if r.slo.kind != "none"),
                key=lambda rid: (-self._prio.get(rid, 0.0), rid))
            self._new_rids.clear()
        return self._order


# ---------------------------------------------------------------------------
# Tempo (LSDF)
# ---------------------------------------------------------------------------
class TempoScheduler(AnalyzedSchedulerBase):
    name = "tempo"

    def __init__(self, predictor: Optional[LengthPredictor] = None,
                 matcher: Optional[DagMatcher] = None,
                 tracker: Optional[SLOTracker] = None,
                 service: Optional[ServiceModel] = None,
                 *, precise: bool = False, use_graph: bool = True,
                 use_predictor: bool = True, reserve: float = 0.1,
                 quanta: int = 20, refine_every: int = 32,
                 fairness_f: float = 0.0,
                 fairness_fn: Optional[Callable[[Request], float]] = None):
        super().__init__(predictor, matcher, tracker, service,
                         precise=precise, use_graph=use_graph,
                         use_predictor=use_predictor, quanta=quanta,
                         refine_every=refine_every)
        self.reserve = reserve
        self.fairness_f = fairness_f
        self.fairness_fn = fairness_fn

    # ------------------------------------------------------------------
    def density(self, req: Request, view: EngineView) -> float:
        """ServiceDensity(r) — Algorithm 1 lines 13–20."""
        now = view.now
        est_out = self._est_upper(req)
        remain = self.tracker.est_remaining_time(req, est_out)
        if req.slo.kind == "collective" and view.dag_remaining is not None:
            remain = max(remain, view.dag_remaining(req.rid))
        est_ttlt = (now - req.arrival) + remain
        gain = self.service.projected_gain(req, est_out, est_ttlt)

        if req.slo.kind == "latency":
            if req.first_token_t is None:
                # TTFT urgency ramps as the deadline approaches; the need
                # is the UNCACHED prefill only — a prefix-cache hit is
                # precise information at admit time that collapses it
                slack = (req.arrival + req.slo.ttft) - now
                need = self.tracker.est_first_token_time(req)
                urgency = 2.0 if slack < 2.0 * need else 0.5
                return urgency * gain / max(remain, 1e-3)
            # per-token pacing is handled in schedule(); density here only
            # ranks latency streams against each other (shedding order)
            return gain / max(remain, 1e-3)

        if req.slo.kind == "none":
            return 0.0               # served via the reserve quota
        # Eq. 4's numerator min{1,(Est_TTLT/SLO)^α} is deadline PRESSURE:
        # loose-slack requests are deferred ("just enough bandwidth"),
        # while projected_gain's §3.1 decay sheds the hopelessly late.
        # The product peaks where the request just makes its deadline.
        slo_ttlt = max(req.deadline - req.arrival, 1e-3)
        pressure = min(1.0, est_ttlt / slo_ttlt) ** self.service.alpha \
            if est_ttlt > 0 else 1.0
        return gain * pressure / max(remain, 1e-3)

    def _priority_raw(self, req: Request, view: EngineView) -> float:
        d = self.density(req, view)
        if self.fairness_f > 0.0 and self.fairness_fn is not None:
            return (1 - self.fairness_f) * d \
                + self.fairness_f * self.fairness_fn(req)
        return d

    # ------------------------------------------------------------------
    def _preempt_ok(self, cand: Request, running: Request,
                    view: EngineView) -> bool:
        """Cost-aware preemption: net benefit must exceed the stall loss.
        The stall is a KV swap-out+in, which only materialises under KV
        pressure — displacement with resident KV is nearly free."""
        stall = 0.0
        if view.kv_free_frac < 0.1:
            kv_bytes = (running.prefilled + running.decoded) \
                * view.kv_block_bytes / view.block_tokens
            stall = 2.0 * kv_bytes / view.swap_bw      # out + back in
        d_new = self._priority(cand, view)
        d_old = self._priority(running, view)
        return (d_new - d_old) * 1.0 > d_old * stall    # 1 s horizon

    def schedule(self, view: EngineView) -> Decision:
        reqs = [r for r in view.requests.values()
                if r.state != ReqState.FINISHED]
        for rid in self._running:
            r = view.requests.get(rid)
            if r is not None and r.state != ReqState.FINISHED:
                self.refine(r, view)
        self._refresh_priorities(view, reqs)

        now = view.now
        decodable = [r for r in reqs if r.prefill_remaining == 0
                     and not r.done]
        at_quanta = (view.step - self._prio_step) == 0  # just refreshed
        order = self._update_order(view, reqs, at_quanta)

        # 1) latency pacing: urgent = next token due within the pacing
        #    window (fraction of the TBT interval elapsed since the last
        #    token).  Ahead-of-schedule requests yield their slot (KV stays
        #    resident) — "just enough bandwidth".  Under overload, urgency
        #    ranks by DENSITY so low-density streams are shed consistently
        #    instead of everyone drifting late together.
        urgent: List[Request] = []
        ahead: List[Request] = []
        for r in decodable:
            if r.slo.kind != "latency":
                continue
            if r.first_token_t is None:
                urgent.append(r)                       # TTFT pending
                continue
            frac = self.tracker.token_due_frac(r, now)
            (urgent if frac >= 0.45 else ahead).append(r)
        urgent.sort(key=lambda r: (-self._priority(r, view),
                                   -self.tracker.token_due_frac(r, now)))

        be_d = sorted((r for r in decodable if r.slo.kind == "none"),
                      key=lambda r: r.arrival)          # FCFS reserve
        reserve_slots = max(1, int(self.reserve * view.max_batch)) \
            if be_d else 0
        cap = view.max_batch - reserve_slots

        decode_ids: List[int] = []
        chosen = set()
        for r in urgent[:cap]:
            decode_ids.append(r.rid)
            chosen.add(r.rid)

        # 2) deadline work by density; membership changes gated by quanta
        #    with cost-aware preemption at the boundary
        deadline_d = {r.rid: r for r in decodable
                      if r.slo.kind in ("throughput", "collective")}
        incumbents = [rid for rid in order
                      if rid in deadline_d and rid in self._running]
        queue = [rid for rid in order
                 if rid in deadline_d and rid not in self._running]
        k = max(cap - len(decode_ids), 0)
        preempted: List[int] = []
        if at_quanta:
            pool = [rid for rid in order if rid in deadline_d]
            sel = pool[:k]
            displaced = [rid for rid in pool[k:] if rid in self._running]
            new_sel = [rid for rid in reversed(sel)
                       if rid not in self._running]
            for old in displaced:
                if not new_sel:
                    break
                new = new_sel[0]
                if not self._preempt_ok(deadline_d[new], deadline_d[old],
                                        view):
                    sel[sel.index(new)] = old      # veto: keep the incumbent
                    new_sel.pop(0)
            preempted = [rid for rid in incumbents if rid not in sel]
        else:
            sel = incumbents[:k]
            sel += queue[:max(k - len(sel), 0)]    # free slots only
        for rid in sel:
            if rid not in chosen:
                decode_ids.append(rid)
                chosen.add(rid)

        # 3) reserve for best-effort, then work-conserving backfill
        for r in be_d:
            if len(decode_ids) >= view.max_batch:
                break
            decode_ids.append(r.rid)
            chosen.add(r.rid)
        if len(decode_ids) < view.max_batch:
            for r in ahead:                             # paced latency
                if len(decode_ids) >= view.max_batch:
                    break
                if r.rid not in chosen:
                    decode_ids.append(r.rid)
                    chosen.add(r.rid)
        if len(decode_ids) < view.max_batch:
            dec_set = {r.rid for r in decodable}
            for rid in order:
                if len(decode_ids) >= view.max_batch:
                    break
                if rid in dec_set and rid not in chosen:
                    decode_ids.append(rid)
                    chosen.add(rid)

        # 4) chunked prefill by cached priority order
        budget = view.prefill_budget
        prefill: Dict[int, int] = {}
        for rid in order:
            if budget <= 0:
                break
            r = view.requests.get(rid)
            if r is None or r.state == ReqState.FINISHED \
                    or r.prefill_remaining == 0:
                continue
            chunk = min(budget, r.prefill_remaining)
            prefill[rid] = chunk
            budget -= chunk
        if budget > 0:                                  # best-effort prefill
            for r in sorted((x for x in reqs if x.slo.kind == "none"
                             and x.prefill_remaining > 0),
                            key=lambda x: x.arrival):
                if budget <= 0:
                    break
                chunk = min(budget, r.prefill_remaining)
                prefill[r.rid] = chunk
                budget -= chunk

        self._running = set(decode_ids)
        return Decision(decode_ids=decode_ids, prefill=prefill,
                        preempted=preempted)
