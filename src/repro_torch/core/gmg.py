"""Grouped Margin Goodput maximization — the paper's §4 namesake algorithm.

Every live request gets an **SLO margin**: the time budget its SLO still
allows minus the *batch-aware* estimate of its remaining service time.  The
estimate is conservative under imprecise information — it uses the QRF
*upper bound* on the output length, relaxed as ``refine()`` tightens the
bound with generation progress — and it is priced under the batch the
request would actually ride in (the tracker's ``StepCostModel``), not a
scalar per-token speed.

Requests are bucketed into **margin groups**, recomputed at quanta
boundaries (plus immediately for fresh arrivals):

  hopeless — so far past the deadline that the §3.1 divisive decay has
             destroyed (almost) all service gain.  Shed: they only ever
             receive leftover capacity, and under KV pressure they are
             dropped outright to free pages — they must not starve the
             rest of the batch.
  late     — projected to miss, but the decayed gain is still worth
             chasing (every extra second decays it further).
  critical — margin below ``crit_frac``×need: the just-in-time band; these
             must run essentially continuously to make their SLO.
  on-track — comfortable margin; scheduled after the critical band.
  slack    — margin above ``slack_frac``×need: **deferred JIT**.  Their KV
             stays resident but the decode slot (and prefill budget) is
             yielded to tighter groups until the margin decays to the
             dispatch threshold.  Residual capacity still backfills them
             work-conservingly — their ride-along cost needs no extra
             gate because every margin is priced under the FULL runnable
             batch; the batch-composition check applies to *hopeless*
             work, whose ~zero residual gain cannot justify slowing a
             batch that still has SLOs to make.

Decode slots and the chunked-prefill token budget are then allocated by
greedy marginal-goodput-per-unit-cost: groups in dispatch order (critical,
late, on-track), within a group by projected-gain density (gain per second
of remaining work).  The batch-composition rule above is the "just enough
bandwidth" principle made concrete: adding a sequence to the batch costs
``Δt = t(b+1, ctx+c) − t(b, ctx)`` per step under the fitted cost model,
and slack/hopeless work is only admitted while the tightest committed
margin can absorb that slowdown.

The scheduler publishes ``margin_summary`` (group counts + aggregate
lateness) each refresh; the cluster's slo-margin router consumes it
instead of re-deriving per-request slack from raw engine state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler import (AnalyzedSchedulerBase, Decision,
                                  EngineView)
from repro_torch.serving.request import ReqState, Request

# dispatch order is by group *rank*; the tuple order here is the margin
# axis (most negative first) — classify_margin is monotone along it
GROUPS = ("hopeless", "late", "critical", "ontrack", "slack")
GROUP_RANK = {g: i for i, g in enumerate(GROUPS)}


def classify_margin(margin: float, need: float, gain_frac: float,
                    *, crit_frac: float = 0.5, slack_frac: float = 2.0,
                    shed_gain: float = 0.05) -> str:
    """Pure group assignment.  For fixed (need, gain_frac) the group index
    along ``GROUPS`` is monotone non-decreasing in ``margin`` — the
    property tests pin this down.

    ``gain_frac`` is the §3.1 decay factor at the projected completion
    time; below ``shed_gain`` a missed request is hopeless (nothing left
    worth serving), which can only happen at negative margin.
    """
    need = max(need, 1e-9)
    if margin < 0.0:
        return "hopeless" if gain_frac < shed_gain else "late"
    if margin < crit_frac * need:
        return "critical"
    if margin < slack_frac * need:
        return "ontrack"
    return "slack"


@dataclasses.dataclass
class MarginInfo:
    margin: float          # budget − batch-aware conservative need (s)
    need: float            # estimated remaining service time (s)
    gain_frac: float       # §3.1 decay factor at projected completion
    density: float         # projected gain per second of remaining work
    group: str
    computed_at: float     # view.now when computed (margins decay 1:1)

    def effective_margin(self, now: float) -> float:
        """Margins are cached at quanta granularity; the budget shrinks
        1:1 with wall time while the need is ~constant, so the cached
        margin decays linearly.  All dispatch decisions use this decayed
        view — a slack request is re-dispatched the moment its *effective*
        margin crosses the threshold, never a quanta later."""
        return self.margin - (now - self.computed_at)


class GroupedMarginScheduler(AnalyzedSchedulerBase):
    name = "gmg"

    def __init__(self, *args, reserve: float = 0.1,
                 crit_frac: float = 0.5, slack_frac: float = 2.0,
                 shed_gain: float = 0.05, kv_shed_frac: float = 0.05,
                 pace_frac: float = 0.45, safety: float = 0.5, **kw):
        super().__init__(*args, **kw)
        self.reserve = reserve
        self.crit_frac = crit_frac
        self.slack_frac = slack_frac
        self.shed_gain = shed_gain
        self.kv_shed_frac = kv_shed_frac   # KV headroom below which
        #                                    hopeless requests are dropped
        self.pace_frac = pace_frac         # latency token-due threshold
        self.safety = safety               # composition-rule margin slack
        self._ginfo: Dict[int, MarginInfo] = {}
        self._bp: Optional[Tuple[int, float, int]] = None   # step cache
        # router-facing summary: group counts + aggregate lateness seconds
        self.margin_summary: Dict[str, object] = {
            "counts": {g: 0 for g in GROUPS}, "lateness": 0.0, "t": 0.0}
        # telemetry roll-ups (threaded into Summary by the runners)
        self.n_quanta = 0              # priority/margin refreshes performed
        self.n_deferrals = 0           # slack→deferred transitions
        self._deferred: set = set()    # rids currently JIT-deferred

    # ------------------------------------------------------------------
    # margin computation
    # ------------------------------------------------------------------
    @staticmethod
    def _batch_profile(view: EngineView) -> Tuple[int, float, int]:
        """Projected decode-batch composition: how many sequences would
        decode if everyone runnable ran, their total context, and the raw
        runnable count.  This is the (conservative) batch the
        remaining-time estimates price; runnable > max_batch means slots
        are time-shared and per-request service is proportionally slower."""
        b, ctx = 0, 0
        for r in view.requests.values():
            if r.state != ReqState.FINISHED and not r.done \
                    and r.prefill_remaining == 0:
                b += 1
                ctx += r.prompt_len + r.decoded
        return min(max(b, 1), view.max_batch), float(ctx), b

    def _budget(self, req: Request, view: EngineView, est_out: float,
                need: float) -> float:
        """Seconds until the latest completion that still meets the SLO."""
        if req.slo.kind == "latency":
            # full-stream timeline; while TTFT is pending the first-token
            # deadline can bind earlier than the stream deadline
            stream = (req.arrival + req.slo.ttft
                      + req.slo.tbt * max(est_out - 1.0, 0.0)) - view.now
            if req.first_token_t is None:
                ttft_margin = (req.arrival + req.slo.ttft) - view.now \
                    - self.tracker.est_first_token_time(req)
                # fold the TTFT constraint into the stream budget so the
                # tighter of the two drives the margin
                stream = min(stream, ttft_margin + need)
            return stream
        return req.deadline - view.now

    def _need(self, req: Request, view: EngineView, est_out: float,
              batch: int, ctx: float, runnable: int) -> float:
        rem_out = max(est_out - req.decoded, 1.0)
        # over-subscribed slots time-share: a request only decodes on
        # runnable/max_batch of the steps, so its effective token interval
        # stretches by that factor — without this the margin is
        # systematically optimistic exactly when the system is loaded,
        # and JIT deferral dispatches too late.  The per-step context must
        # then be the RESIDENT batch's share of the total (only max_batch
        # sequences are read per step) — pricing all runnable context AND
        # stretching would double-count the over-subscription
        over = max(runnable / max(view.max_batch, 1), 1.0)
        ctx_step = ctx * batch / max(runnable, 1)
        need = self.tracker.est_prefill_time(req.prefill_remaining) \
            + over * self.tracker.est_decode_time(rem_out, batch, ctx_step)
        if req.slo.kind == "collective" and view.dag_remaining is not None:
            need = max(need, view.dag_remaining(req.rid))
        return need

    def margin_of(self, req: Request, view: EngineView,
                  batch: Optional[int] = None,
                  ctx: Optional[float] = None,
                  runnable: Optional[int] = None) -> MarginInfo:
        if batch is None or ctx is None or runnable is None:
            # one O(n) profile per engine step (cached in schedule());
            # recomputing it per request would make every priority
            # refresh O(n^2) for no accuracy gain
            bp = self._bp if self._bp is not None \
                else self._batch_profile(view)
            batch, ctx, runnable = bp
        est_out = self._est_upper(req)
        need = self._need(req, view, est_out, batch, ctx, runnable)
        budget = self._budget(req, view, est_out, need)
        margin = budget - need
        est_ttlt = (view.now - req.arrival) + need
        if req.slo.kind == "latency":
            slo_ttlt = req.slo.ttft + req.slo.tbt * max(est_out - 1.0, 0.0)
        else:
            slo_ttlt = max(req.deadline - req.arrival, 1e-3)
        gain_frac = self.service.degrade(slo_ttlt, est_ttlt)
        gain = self.service.projected_gain(req, est_out, est_ttlt)
        group = classify_margin(margin, need, gain_frac,
                                crit_frac=self.crit_frac,
                                slack_frac=self.slack_frac,
                                shed_gain=self.shed_gain)
        if group == "hopeless" and req.slo.kind == "collective":
            # an unserved collective member blocks its DAG's stage barrier
            # — the member's own decayed gain understates the chain's
            # remaining value, and it cannot be shed, so starving it would
            # zombie the whole DAG.  Treat it as (very) late instead.
            group = "late"
        return MarginInfo(margin=margin, need=need, gain_frac=gain_frac,
                          density=gain / max(need, 1e-3), group=group,
                          computed_at=view.now)

    def _est_upper(self, req: Request) -> float:
        """Conservative output bound for margin purposes.  A request that
        has (nearly) outlived its predicted upper bound has revealed a
        heavy tail the QRF's quantile missed — clamping to decoded+1
        (the base behaviour) would collapse the remaining-need estimate
        to one step, inflate the margin, and JIT-defer the request into a
        one-token-per-dispatch crawl.  Assume a residual proportional to
        what it has already produced instead (lognormal-ish tails: the
        longer it has run, the longer it is likely to keep running)."""
        ub = super()._est_upper(req)
        if not self.precise and req.decoded > 0:
            ub = max(ub, req.decoded + max(8.0, 0.25 * req.decoded))
        return ub

    # the priority cache stores the density; groups live in _ginfo.
    # Best-effort traffic is served from the reserve, never grouped.
    def _priority_raw(self, req: Request, view: EngineView) -> float:
        if req.slo.kind == "none":
            return 0.0
        info = self.margin_of(req, view)
        self._ginfo[req.rid] = info
        return info.density

    def _info(self, req: Request, view: EngineView) -> MarginInfo:
        gi = self._ginfo.get(req.rid)
        if gi is None:
            gi = self.margin_of(req, view)
            self._ginfo[req.rid] = gi
        return gi

    def _refresh_groups(self, view: EngineView,
                        reqs: List[Request]) -> None:
        """Recompute priorities AND margins at the shared quanta cadence;
        between refreshes, fresh arrivals are inserted immediately and
        cached margins decay via effective_margin()."""
        self._refresh_priorities(view, reqs)
        if (view.step - self._prio_step) == 0:       # just refreshed
            live = {r.rid for r in reqs}
            self._ginfo = {rid: gi for rid, gi in self._ginfo.items()
                           if rid in live}
        # no cached global order here (unlike Tempo, gmg builds per-group
        # orders each step); fresh arrivals are primed by the _info pass
        # below, which is what makes them schedulable immediately
        self._new_rids.clear()
        counts = {g: 0 for g in GROUPS}
        lateness = 0.0
        for r in reqs:
            if r.slo.kind == "none":
                continue
            gi = self._info(r, view)           # lazily cover stragglers
            counts[gi.group] += 1
            if gi.group in ("late", "hopeless"):
                lateness += max(-gi.effective_margin(view.now), 0.0)
        self.margin_summary = {"counts": counts, "lateness": lateness,
                               "t": view.now}
        if (view.step - self._prio_step) == 0:   # a refresh happened above
            self.n_quanta += 1
            obs = self.obs
            obs.counter("sched_quanta_total",
                        "margin-group refreshes").inc(t=view.now)
            for g, n in counts.items():
                obs.gauge("sched_group_size",
                          "margin-group census at quanta refresh",
                          group=g).set(n, t=view.now)
            obs.gauge("sched_group_lateness_seconds",
                      "aggregate lateness of late+hopeless work"
                      ).set(lateness, t=view.now)

    # ------------------------------------------------------------------
    # speculative depth policy (DESIGN.md §11)
    # ------------------------------------------------------------------
    # draft depth by margin group: slack/ahead lanes are already making
    # their SLOs at one token per step, so verification compute is wasted
    # on them (and hopeless lanes earn nothing from arriving faster);
    # on-track lanes take a shallow window; late/critical lanes — the ones
    # whose margin a >1 tokens/step rate can actually rescue — go deep
    # (the engine clamps by EngineConfig.spec_depth_max and KV headroom)
    SPEC_DEPTH = {"hopeless": 0, "late": 8, "critical": 8, "ontrack": 2,
                  "slack": 0, "ahead": 0}
    # below this EWMA accept rate the drafter is misfiring on the request
    # (verification compute buys < ~1.2 tokens/step) — stop speculating
    SPEC_EWMA_MIN = 0.15

    def spec_depth(self, view: EngineView) -> Dict[int, int]:
        depths: Dict[int, int] = {}
        for r in view.requests.values():
            if r.state == ReqState.FINISHED or r.done \
                    or r.prefill_remaining > 0:
                continue
            if r.slo.kind == "none":
                d = self.SPEC_DEPTH["ontrack"]   # best-effort: shallow
            else:
                d = self.SPEC_DEPTH[self._dispatch_group(r, view)]
            ew = r.spec_accept_ewma
            if d > 0 and ew is not None and ew < self.SPEC_EWMA_MIN:
                d = 0
            depths[r.rid] = d
        if self.obs.enabled:
            for g, d in self.SPEC_DEPTH.items():
                self.obs.gauge(
                    "sched_spec_depth", "draft depth granted per margin "
                    "group (pre-clamp)", group=g).set(d, t=view.now)
        return depths

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    _DISPATCH = ("critical", "late", "ontrack")   # slot order, tight first

    def _dispatch_group(self, req: Request, view: EngineView) -> str:
        """Step-granular group: the cached group, tightened by the margin
        decay since it was computed and by latency token pacing."""
        gi = self._info(req, view)
        g = gi.group
        eff = gi.effective_margin(view.now)
        # decayed past a boundary? re-classify on the effective margin
        # (cheap — no estimator calls)
        if g in ("slack", "ontrack", "critical"):
            g = classify_margin(eff, gi.need, gi.gain_frac,
                                crit_frac=self.crit_frac,
                                slack_frac=self.slack_frac,
                                shed_gain=self.shed_gain)
        if req.slo.kind == "latency" and req.first_token_t is not None:
            frac = self.tracker.token_due_frac(req, view.now)
            if frac >= self.pace_frac and GROUP_RANK[g] > \
                    GROUP_RANK["critical"]:
                g = "critical"        # next token is due: JIT dispatch
            elif frac < self.pace_frac and g in ("ontrack", "critical",
                                                 "slack") \
                    and gi.margin > 0:
                # ahead of the token timeline: yield the slot, but stay
                # first in line for idle capacity — TBT is fragile (one
                # long prefill-heavy step can blow it), so ahead streams
                # are never gated behind the batch-composition rule
                g = "ahead"
        return g

    def _marginal_step_cost(self, batch: int, ctx: float,
                            req: Request) -> float:
        """Δ step time from adding ``req`` to a (batch, ctx) decode batch
        under the fitted cost model — the unit cost the greedy allocation
        divides by."""
        c = req.prompt_len + req.decoded
        return max(self.tracker.est_step_time(batch + 1, ctx + c)
                   - self.tracker.est_step_time(batch, ctx), 1e-6)

    def schedule(self, view: EngineView) -> Decision:
        reqs = [r for r in view.requests.values()
                if r.state != ReqState.FINISHED]
        for rid in self._running:
            r = view.requests.get(rid)
            if r is not None and r.state != ReqState.FINISHED:
                self.refine(r, view)
        self._bp = self._batch_profile(view)
        self._refresh_groups(view, reqs)
        now = view.now

        decodable = [r for r in reqs if r.prefill_remaining == 0
                     and not r.done]
        by_group: Dict[str, List[Request]] = {g: [] for g in
                                              GROUPS + ("ahead",)}
        be_d: List[Request] = []
        for r in decodable:
            if r.slo.kind == "none":
                be_d.append(r)
            else:
                by_group[self._dispatch_group(r, view)].append(r)
        be_d.sort(key=lambda r: (r.arrival, r.rid))
        reserve_slots = max(1, int(self.reserve * view.max_batch)) \
            if be_d else 0
        cap = view.max_batch - reserve_slots

        # 1) greedy fill, tightest groups first, density within a group.
        #    Track the running batch composition so backfill can price its
        #    marginal cost, and the tightest committed margin so the
        #    composition rule has something to protect.
        decode_ids: List[int] = []
        chosen = set()
        cur_b, cur_ctx = 0, 0.0
        tight_margin = float("inf")
        tight_steps = 1.0

        def _commit(r: Request, tight: bool) -> None:
            nonlocal cur_b, cur_ctx, tight_margin, tight_steps
            decode_ids.append(r.rid)
            chosen.add(r.rid)
            cur_b += 1
            cur_ctx += r.prompt_len + r.decoded
            if tight:
                gi = self._ginfo.get(r.rid)
                if gi is not None:
                    eff = gi.effective_margin(now)
                    if eff < tight_margin:
                        tight_margin = eff
                        tight_steps = max(self._est_upper(r) - r.decoded,
                                          1.0)

        for g in self._DISPATCH:
            if g == "late":
                # already missing: rank by salvage value per unit work
                members = sorted(by_group[g],
                                 key=lambda r: (-self._priority(r, view),
                                                r.rid))
            else:
                # still makeable: tightest margin first (EDF within the
                # band) — when a DAG stage spawn spikes the runnable count
                # past the cap, the request closest to its cliff must not
                # lose its slot to a higher-density-but-looser one
                members = sorted(by_group[g],
                                 key=lambda r: (
                                     self._info(r, view)
                                     .effective_margin(now),
                                     -self._priority(r, view), r.rid))
            for r in members:
                if len(decode_ids) >= cap:
                    break
                _commit(r, tight=True)

        # 2) best-effort reserve (FCFS — starvation-proof): only the
        #    GUARANTEED reserve here; surplus best-effort work waits for
        #    step 3c so ahead-paced latency keeps first claim on idle
        #    capacity, as documented
        n_be = 0
        for r in be_d:
            if n_be >= reserve_slots or len(decode_ids) >= view.max_batch:
                break
            _commit(r, tight=False)
            n_be += 1

        # 3a) ahead-paced latency streams: first claim on idle slots (KV
        #     resident, cheap, TBT-fragile) — soonest-due first, exempt
        #     from the composition rule
        for r in sorted(by_group["ahead"],
                        key=lambda r: (-self.tracker.token_due_frac(r, now),
                                       r.rid)):
            if len(decode_ids) >= view.max_batch:
                break
            _commit(r, tight=False)

        # 3b) work-conserving slack backfill, closest to dispatch first.
        #     No composition gate: every margin was priced under the FULL
        #     decodable batch (_batch_profile), so the committed requests
        #     have already paid for these sequences riding along.
        for r in sorted(by_group["slack"],
                        key=lambda r: (
                            self._ginfo[r.rid].effective_margin(now)
                            if r.rid in self._ginfo else 0.0, r.rid)):
            if len(decode_ids) >= view.max_batch:
                break
            _commit(r, tight=False)

        # 3c) surplus best-effort beyond the reserve (work-conserving)
        for r in be_d[n_be:]:
            if len(decode_ids) >= view.max_batch:
                break
            if r.rid not in chosen:
                _commit(r, tight=False)

        # 3d) hopeless work rides along ONLY while the marginal step time
        #     it adds cannot push the tightest committed request past its
        #     (safety-discounted) margin over its remaining tokens — the
        #     batch-composition rule: a sequence with ~zero residual gain
        #     must never slow a batch that still has SLOs to make.
        for r in sorted(by_group["hopeless"],
                        key=lambda r: (-self._priority(r, view), r.rid)):
            if len(decode_ids) >= view.max_batch:
                break
            if r.rid in chosen:
                continue
            delta = self._marginal_step_cost(max(cur_b, 1), cur_ctx, r)
            if tight_margin < float("inf") and \
                    delta * tight_steps > self.safety * max(tight_margin,
                                                            0.0):
                continue    # composition rule: this one is too heavy, but
                #             a smaller-context candidate may still fit
            _commit(r, tight=False)

        # 4) shed: under KV pressure, hopeless singles are dropped outright
        #    (state machine + accounting happen in the engine).  Collective
        #    members are never shed — a dropped sibling would corrupt the
        #    DAG's stage barrier.
        shed: List[int] = []
        if view.kv_free_frac < self.kv_shed_frac:
            n_shed_decode = 0
            for r in sorted(by_group["hopeless"],
                            key=lambda r: (-(r.prompt_len + r.decoded),
                                           r.rid)):
                if r.slo.kind == "collective" or r.dag_id is not None:
                    continue
                shed.append(r.rid)
                self._dirty = True
                n_shed_decode += 1
            # also consider hopeless requests still mid-prefill: they hold
            # KV and cannot possibly pay back
            n_shed_prefill = 0
            for r in reqs:
                if r.prefill_remaining > 0 and r.dag_id is None \
                        and r.slo.kind not in ("none", "collective"):
                    gi = self._ginfo.get(r.rid)
                    if gi is not None and gi.group == "hopeless" \
                            and r.rid not in shed:
                        shed.append(r.rid)
                        self._dirty = True
                        n_shed_prefill += 1
            # 4b) weighted-fairness relief (multi-tenant fleets, DESIGN.md
            #     §13): if the pool is still deeply pressured after the
            #     hopeless sheds, drop LATE singles of over-share tenants —
            #     lowest fairness weight first, largest context first — but
            #     never push a tenant below its weight-proportional share
            #     of the live tenanted work (the starved-tenant invariant).
            #     Untenanted runs never enter: no request carries a tenant.
            n_shed_fair = 0
            if view.kv_free_frac < 0.5 * self.kv_shed_frac:
                live_n: Dict[str, int] = {}
                live_w: Dict[str, float] = {}
                for r in reqs:
                    if r.tenant and r.rid not in shed:
                        live_n[r.tenant] = live_n.get(r.tenant, 0) + 1
                        live_w[r.tenant] = float(
                            r.meta.get("tenant_weight", 1.0))
                if live_n:
                    tot_n = sum(live_n.values())
                    tot_w = sum(live_w.values()) or 1.0
                    over = {t: live_n[t]
                            - math.ceil(tot_n * live_w[t] / tot_w)
                            for t in live_n}
                    cands = [r for r in by_group["late"]
                             if r.tenant and r.dag_id is None
                             and r.slo.kind not in ("none", "collective")
                             and r.rid not in shed]
                    cands.sort(key=lambda r: (
                        float(r.meta.get("tenant_weight", 1.0)),
                        -(r.prompt_len + r.decoded), r.rid))
                    for r in cands:
                        if over.get(r.tenant, 0) <= 0:
                            continue
                        shed.append(r.rid)
                        over[r.tenant] -= 1
                        self._dirty = True
                        n_shed_fair += 1
            if n_shed_decode:
                self.obs.counter("sched_shed_total",
                                 "sheds by reason",
                                 reason="hopeless_decode"
                                 ).inc(n_shed_decode, t=now)
            if n_shed_prefill:
                self.obs.counter("sched_shed_total", "sheds by reason",
                                 reason="hopeless_prefill"
                                 ).inc(n_shed_prefill, t=now)
            if n_shed_fair:
                self.obs.counter("sched_shed_total", "sheds by reason",
                                 reason="tenant_fairness"
                                 ).inc(n_shed_fair, t=now)
        shed_set = set(shed)
        if shed_set:
            decode_ids = [rid for rid in decode_ids if rid not in shed_set]
            chosen -= shed_set

        # 5) chunked prefill by the same grouped order: tight groups by
        #    density, then best-effort (FCFS), then slack JIT-deferred
        #    (closest to dispatch first).  Hopeless prompts get nothing —
        #    prefilling them would allocate KV for zero goodput.
        budget = view.prefill_budget
        prefill: Dict[int, int] = {}

        def _grant(r: Request) -> None:
            nonlocal budget
            chunk = min(budget, r.prefill_remaining)
            if chunk > 0:
                prefill[r.rid] = chunk
                budget -= chunk

        prefillable = [r for r in reqs if r.prefill_remaining > 0
                       and r.rid not in shed_set]
        # "ahead" is unreachable for prefillable requests (no first token
        # before prefill completes) but the key keeps the mapping total
        pf_groups: Dict[str, List[Request]] = {g: [] for g in
                                               GROUPS + ("ahead",)}
        pf_be: List[Request] = []
        for r in prefillable:
            if r.slo.kind == "none":
                pf_be.append(r)
            else:
                # same decayed step-granular reclassification the decode
                # path uses — a prompt whose cached slack has evaporated
                # must not wait out the quanta in the slack bucket
                pf_groups[self._dispatch_group(r, view)].append(r)
        for g in self._DISPATCH:
            for r in sorted(pf_groups[g],
                            key=lambda r: (-self._priority(r, view),
                                           r.rid)):
                if budget <= 0:
                    break
                _grant(r)
        for r in sorted(pf_be, key=lambda r: (r.arrival, r.rid)):
            if budget <= 0:
                break
            _grant(r)
        for r in sorted(pf_groups["slack"],
                        key=lambda r: (
                            self._ginfo[r.rid].effective_margin(now)
                            if r.rid in self._ginfo else 0.0, r.rid)):
            if budget <= 0:
                break
            _grant(r)
        # work-conserving last resort: hopeless prompts only ever see
        # budget nobody else wanted — they must still finish EVENTUALLY
        # (counting as misses) rather than livelocking the engine as
        # permanently-live zombies that can never become decodable
        for r in sorted(pf_groups["hopeless"],
                        key=lambda r: (-self._priority(r, view), r.rid)):
            if budget <= 0:
                break
            _grant(r)

        # preemption accounting mirrors Tempo's: only genuine displacement
        # (a TIGHT-group request that held a slot and lost it to the cap)
        # is reported.  JIT-deferred slack and paced-ahead latency yields
        # are silent — the slot was given up voluntarily, KV stays
        # resident, and counting them would read as thrash.
        group_of = {r.rid: g for g, rs in by_group.items() for r in rs}
        preempted = [rid for rid in self._running
                     if rid not in chosen and rid not in shed_set
                     and group_of.get(rid) in self._DISPATCH]
        self._running = set(decode_ids)

        # JIT-deferral accounting: a decodable slack request not chosen
        # this step is deferred; count and trace only the TRANSITIONS
        # (deferral persists across many steps — per-step events would
        # read as thrash).  A deferred request that leaves the set has
        # resumed: it was re-dispatched, reclassified tighter, or shed.
        deferred = {r.rid for r in by_group["slack"]
                    if r.rid not in chosen and r.rid not in shed_set}
        newly = deferred - self._deferred
        resumed = self._deferred - deferred
        if newly:
            self.n_deferrals += len(newly)
            self.obs.counter("sched_defer_total",
                             "JIT deferrals (slack slot yields)"
                             ).inc(len(newly), t=now)
            if self.tracer.enabled:
                for rid in sorted(newly):
                    self.tracer.event("defer", rid, now, self.replica)
        if resumed and self.tracer.enabled:
            for rid in sorted(resumed):
                self.tracer.event("resume", rid, now, self.replica)
        self._deferred = deferred
        return Decision(decode_ids=decode_ids, prefill=prefill,
                        preempted=preempted, shed=shed)
