"""ClusterEngine: one workload, N co-simulated ``ServeEngine`` replicas.

Conservative discrete-event co-simulation.  Each replica is an unmodified
``ServeEngine`` (own scheduler, own KV pool, own backend, own clock); the
cluster loop always processes the globally earliest event — either the next
workload arrival (routed to a replica and enqueued) or one engine step of
the replica whose ``peek_next_event()`` is smallest.  An arrival is routed
*before* any busier replica's clock passes it, so router decisions see every
replica's state as of the arrival instant (up to engine-step granularity,
the same discretisation a single engine has).

Collective DAGs are dispatched atomically: the ("dag", (dag, stage0)) event
lands on one replica, whose engine spawns all later stages locally through
the shared ``WorkloadGen`` — stage advancement never crosses replicas.

Autoscaling hooks in at event granularity: the ``Autoscaler`` watches the
fleet's finished-request stream and queue depths, spawns replicas (with a
cold-start delay) or gracefully drains them (no new traffic, retire when
empty).

Event selection is vectorized by default (DESIGN.md §13): a maintained
numpy array caches every replica's next-event time and only replicas whose
state actually changed (stepped, routed-to, handoff destination, retired,
spawned) are re-peeked before an ``np.argmin`` pick.  The O(active) per-event
python scan is retained behind ``vectorized=False`` as the equivalence
baseline; both paths share the same arrival/step handlers, so results are
identical.  ``profile=True`` attributes wall-clock event-loop time by phase
(select / route / step / harvest / migrate / scale).
"""

from __future__ import annotations

from time import perf_counter
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.cluster.autoscaler import Autoscaler
from repro_torch.cluster.router import Router
from repro_torch.obs import NULL
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import ReqState, Request


class Replica:
    def __init__(self, rid: int, engine: ServeEngine,
                 spawned_at: float = 0.0):
        self.rid = rid
        self.engine = engine
        self.spawned_at = spawned_at
        self.draining = False
        self.retired_at: Optional[float] = None
        self._fin_cursor = 0           # engine.finished already harvested

    # -- router-facing load signals ------------------------------------
    @property
    def role(self) -> str:
        """Replica role in a disaggregated fleet (DESIGN.md §12)."""
        return getattr(self.engine.cfg, "role", "mixed")

    def live_count(self) -> int:
        return sum(1 for r in self.engine.requests.values()
                   if r.state != ReqState.FINISHED)

    def queue_len(self) -> int:
        """Live requests plus not-yet-admitted queued ones (including
        in-flight migrations addressed here)."""
        q = self.live_count() + self.engine.inbound_count
        for kind, obj in self.engine.pending_items():
            q += 1 if kind == "r" else len(obj[1])
        return q

    def kv_used_frac(self) -> float:
        """KV pressure with reclaimable (cold-cached) blocks counted as
        free — a replica full of cold cache is NOT under pressure."""
        return 1.0 - self.engine.kv.available_frac

    def kv_free_tokens(self) -> int:
        """ABSOLUTE KV headroom (tokens) — the replica's mesh-wide
        aggregate pool (DESIGN.md §8: a tp-sharded replica hosts tp× the
        pages per device budget), so routers can prefer the bigger mesh
        in a heterogeneous fleet even at equal utilisation fractions."""
        return self.engine.kv.free_tokens()


class ClusterEngine:
    def __init__(self, replica_factory: Callable[[int], ServeEngine],
                 router: Router, n_replicas: int = 2,
                 autoscaler: Optional[Autoscaler] = None, obs=None,
                 vectorized: bool = True, profile: bool = False):
        if n_replicas < 1:
            raise ValueError("a cluster needs at least one replica")
        self.replica_factory = replica_factory
        self.router = router
        self.autoscaler = autoscaler
        self.vectorized = vectorized
        self.profile_enabled = profile
        # wall-clock seconds of event-loop time by phase, plus the number
        # of selection decisions made ("events"); populated when
        # profile=True, in both the vectorized and the legacy-scan path
        self.profile: Dict[str, float] = {
            "select": 0.0, "route": 0.0, "step": 0.0,
            "harvest": 0.0, "migrate": 0.0, "scale": 0.0, "events": 0}
        # fleet-level registry (DESIGN.md §9); replica engines report into
        # per-replica labeled views of the same registry via the factory
        self.obs = obs if obs is not None else NULL
        router.obs = self.obs
        if autoscaler is not None:
            autoscaler.obs = self.obs
        self.replicas: List[Replica] = [
            Replica(i, replica_factory(i)) for i in range(n_replicas)]
        self._next_rid = n_replicas
        # vectorized event selection state: cached next-event time per
        # replica-list index (inf = no event / retired), the set of indices
        # whose cache is stale, and rid -> list index.  List order is
        # append-only and rid-monotonic, so np.argmin's first-min-index
        # tie-break reproduces the legacy min((t, rid)) tie-break exactly.
        self._peek = np.full(n_replicas, np.inf)
        self._dirty: Set[int] = set(range(n_replicas))
        self._idx: Dict[int, int] = {i: i for i in range(n_replicas)}
        self.now = 0.0                   # fleet clock (max event time seen)
        self.routed: Dict[int, int] = {rep.rid: 0 for rep in self.replicas}
        self.migrations = 0              # completed handoff_out dispatches
        # (t, replica_id, new_role) at every autoscaler role flip
        self.role_timeline: List[Tuple[float, int, str]] = []
        # (t, n_active) recorded at every fleet-size change
        self.replica_timeline: List[Tuple[float, int]] = [(0.0, n_replicas)]
        self.obs.gauge("cluster_active_replicas", "active fleet size"
                       ).set(n_replicas, t=0.0)

    # ------------------------------------------------------------------
    def active(self) -> List[Replica]:
        return [rep for rep in self.replicas
                if not rep.draining and rep.retired_at is None]

    def _stepable(self) -> List[Replica]:
        return [rep for rep in self.replicas if rep.retired_at is None]

    # ------------------------------------------------------------------
    def run(self, stream) -> Dict[int, List[Request]]:
        """Drive the co-simulation to completion over an arrival stream of
        (t, kind, obj) events.  Returns {replica_id: finished requests}."""
        it = iter(stream)
        nxt = next(it, None)
        if self.vectorized:
            self._run_vectorized(it, nxt)
        else:
            self._run_scan(it, nxt)
        for rep in self.replicas:              # drain stragglers' stats
            self._harvest(rep)
        return {rep.rid: rep.engine.finished for rep in self.replicas}

    def _run_vectorized(self, it, nxt) -> None:
        """Event loop with cached next-event times: only dirty replicas are
        re-peeked, selection is a single np.argmin over the fleet."""
        prof, pr = self.profile_enabled, self.profile
        self._dirty.update(range(len(self.replicas)))
        while True:
            t0 = perf_counter() if prof else 0.0
            if self._dirty:
                peek = self._peek
                for i in self._dirty:
                    rep = self.replicas[i]
                    if rep.retired_at is not None:
                        peek[i] = np.inf
                    else:
                        tn = rep.engine.peek_next_event()
                        peek[i] = np.inf if tn is None else tn
                self._dirty.clear()
            i_min = int(np.argmin(self._peek))
            t_min = float(self._peek[i_min])
            t_rep = None if t_min == np.inf else t_min
            if prof:
                pr["select"] += perf_counter() - t0
                pr["events"] += 1
            if nxt is not None and (t_rep is None or nxt[0] <= t_rep):
                self._route_arrival(nxt)
                nxt = next(it, None)
                continue
            if t_rep is None:
                break
            rep = self.replicas[i_min]
            self._dirty.add(i_min)
            self._step_replica(rep)

    def _run_scan(self, it, nxt) -> None:
        """Legacy O(active) per-event python scan — kept as the equivalence
        baseline for the vectorized loop (and its speedup microbench)."""
        prof, pr = self.profile_enabled, self.profile
        while True:
            t0 = perf_counter() if prof else 0.0
            evs = [(rep.engine.peek_next_event(), rep.rid, rep)
                   for rep in self._stepable()]
            evs = [e for e in evs if e[0] is not None]
            t_rep = min(evs)[0] if evs else None
            rep = min(evs)[2] if evs else None
            if prof:
                pr["select"] += perf_counter() - t0
                pr["events"] += 1
            if nxt is not None and (t_rep is None or nxt[0] <= t_rep):
                self._route_arrival(nxt)
                nxt = next(it, None)
                continue
            if rep is None:
                break
            self._step_replica(rep)

    def _route_arrival(self, nxt) -> None:
        t, kind, obj = nxt
        self.now = max(self.now, t)
        self._maybe_scale(self.now)
        prof = self.profile_enabled
        t0 = perf_counter() if prof else 0.0
        rep = self.router.route(kind, obj, self.active(), t)
        rep.engine.enqueue(kind, obj)
        self._dirty.add(self._idx[rep.rid])
        self.routed[rep.rid] = self.routed.get(rep.rid, 0) \
            + (1 if kind == "r" else len(obj[1]))
        self.router.note_route(rep, kind, t)
        if self.obs.enabled:
            # per-replica load snapshot at every routing instant —
            # the signal the router actually saw
            for rp in self.active():
                self.obs.gauge("cluster_queue_len",
                               "live+queued requests",
                               replica=rp.rid
                               ).set(rp.queue_len(), t=t)
                self.obs.gauge("cluster_kv_used_frac",
                               "replica KV pressure",
                               replica=rp.rid
                               ).set(rp.kv_used_frac(), t=t)
        if prof:
            self.profile["route"] += perf_counter() - t0

    def _step_replica(self, rep: Replica) -> None:
        prof = self.profile_enabled
        t0 = perf_counter() if prof else 0.0
        ok = rep.engine.step_once()
        if prof:
            self.profile["step"] += perf_counter() - t0
        if not ok:                             # max_steps safety valve
            rep.retired_at = rep.engine.now
            self._dirty.add(self._idx[rep.rid])
            return
        self.now = max(self.now, rep.engine.now)
        self._harvest(rep)
        self._maybe_migrate(rep)
        if rep.draining and rep.engine.peek_next_event() is None:
            rep.retired_at = rep.engine.now
            self._dirty.add(self._idx[rep.rid])

    # ------------------------------------------------------------------
    def _harvest(self, rep: Replica) -> None:
        prof = self.profile_enabled
        t0 = perf_counter() if prof else 0.0
        new = rep.engine.finished[rep._fin_cursor:]
        if new:
            rep._fin_cursor = len(rep.engine.finished)
            if self.autoscaler is not None:
                for r in new:
                    self.autoscaler.observe_finish(r, r.finish_t)
        if prof:
            self.profile["harvest"] += perf_counter() - t0
        if new and self.autoscaler is not None:
            self._maybe_scale(self.now)

    # ------------------------------------------------------------------
    # Live KV migration (DESIGN.md §12): after a prefill replica's step,
    # offer every request that just finished its prompt to the router for
    # decode placement elsewhere.  The router prices the wire transfer
    # against destination margin and may return None — the request then
    # simply decodes locally (the TTFT fallback).  Only singles migrate:
    # DAGs are dispatched replica-atomically (stage spawning is local).
    def _maybe_migrate(self, rep: Replica) -> None:
        if rep.role != "prefill" or rep.draining:
            return
        chooser = getattr(self.router, "choose_decode_target", None)
        if chooser is None:
            return          # role-unaware router: roles are routing-only
        prof = self.profile_enabled
        t0 = perf_counter() if prof else 0.0
        act = self.active()
        if len(act) >= 2:
            eng = rep.engine
            cands = [r for r in eng.requests.values()
                     if r.state != ReqState.FINISHED and not r.done
                     and r.dag_id is None and r.decoded == 0
                     and r.prefill_remaining == 0]
            for r in cands:
                a = eng.kv.seqs.get(r.rid)
                if a is None or a.swapped:
                    continue
                t_xfer = eng.backend.migrate_time(
                    a.tokens * eng.kv.kv_bytes_per_token)
                dst = chooser(r, rep, act, eng.now, t_xfer)
                if dst is None or dst is rep:
                    continue
                out = eng.handoff_out(r.rid)
                if out is None:
                    continue
                req, pkg = out
                arrive = eng.now + t_xfer
                if eng.tracer.enabled:
                    eng.tracer.event("transfer", req.rid, eng.now, rep.rid,
                                     dst=dst.rid, bytes=int(pkg["bytes"]),
                                     eta=round(arrive, 6))
                dst.engine.enqueue_handoff(req, pkg, arrive)
                self._dirty.add(self._idx[dst.rid])
                self.migrations += 1
                self.obs.counter("cluster_migrations_total",
                                 "prefill->decode KV handoffs",
                                 src=rep.rid, dst=dst.rid).inc(t=eng.now)
        if prof:
            self.profile["migrate"] += perf_counter() - t0

    def _maybe_scale(self, t: float) -> None:
        if self.autoscaler is None:
            return
        prof = self.profile_enabled
        t0 = perf_counter() if prof else 0.0
        act = self.active()
        if act:
            mean_queue = sum(rep.queue_len() for rep in act) / len(act)
            d = self.autoscaler.decide(t, len(act), mean_queue,
                                       act[0].engine.cfg.max_batch)
            if d > 0:
                self._spawn(t)
            elif d < 0:
                self._drain(t, act)
            else:
                self._maybe_flip_role(t, act)
        if prof:
            self.profile["scale"] += perf_counter() - t0

    def _role_loads(self, act: List[Replica]) -> Tuple[float, float]:
        """Per-role backlog in STEP-EQUIVALENTS per capable replica:
        prefill load = pending prompt tokens / prefill budget, decode
        load = live decode-phase requests / batch slots — comparable
        units, so a ratio between them reads as relative pressure."""
        pf_tok, dc_n = 0, 0
        for rep in act:
            for r in rep.engine.requests.values():
                if r.state == ReqState.FINISHED or r.done:
                    continue
                if r.prefill_remaining > 0:
                    pf_tok += r.prefill_remaining
                else:
                    dc_n += 1
            dc_n += rep.engine.inbound_count
            for kind, obj in rep.engine.pending_items():
                for r in Router.item_requests(kind, obj):
                    pf_tok += r.prompt_len
        cfg = act[0].engine.cfg
        pf_cap = sum(1 for rep in act if rep.role in ("prefill", "mixed"))
        dc_cap = sum(1 for rep in act if rep.role in ("decode", "mixed"))
        pf = pf_tok / max(cfg.prefill_budget, 1) / max(pf_cap, 1)
        dc = dc_n / max(cfg.max_batch, 1) / max(dc_cap, 1)
        return pf, dc

    def _maybe_flip_role(self, t: float, act: List[Replica]) -> None:
        flip = getattr(self.autoscaler, "decide_role", None)
        if flip is None:
            return
        mixed = [rep for rep in act if rep.role == "mixed"]
        pf, dc = self._role_loads(act)
        role = flip(t, pf, dc, len(mixed))
        if role is None:
            return
        # flip the emptiest mixed replica: least in-flight work whose
        # phase mismatches the new specialisation
        rep = min(mixed, key=lambda r: (r.queue_len(), r.rid))
        rep.engine.cfg.role = role
        self.role_timeline.append((t, rep.rid, role))
        self.obs.counter("cluster_role_flips_total",
                         "mixed replicas specialised by the autoscaler",
                         role=role).inc(t=t)

    def _spawn(self, t: float) -> None:
        rid = self._next_rid
        self._next_rid += 1
        eng = self.replica_factory(rid)
        eng.now = t + self.autoscaler.cfg.cold_start_s
        rep = Replica(rid, eng, spawned_at=t)
        self.replicas.append(rep)
        self._idx[rid] = len(self.replicas) - 1
        self._peek = np.append(self._peek, np.inf)
        self._dirty.add(self._idx[rid])
        self.routed[rid] = 0
        self.replica_timeline.append((t, len(self.active())))
        self.obs.gauge("cluster_active_replicas", "active fleet size"
                       ).set(len(self.active()), t=t)

    def _drain(self, t: float, act: List[Replica]) -> None:
        # drain the emptiest replica: least work lost behind the barrier
        rep = min(act, key=lambda r: (r.queue_len(), -r.rid))
        rep.draining = True
        if rep.engine.peek_next_event() is None:
            rep.retired_at = t
            self._dirty.add(self._idx[rep.rid])
        self.replica_timeline.append((t, len(self.active())))
        self.obs.gauge("cluster_active_replicas", "active fleet size"
                       ).set(len(self.active()), t=t)

    # ------------------------------------------------------------------
    @property
    def makespan(self) -> float:
        return max([self.now] + [rep.engine.now for rep in self.replicas])

    @property
    def preempt_count(self) -> int:
        return sum(rep.engine.preempt_count for rep in self.replicas)
