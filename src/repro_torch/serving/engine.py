"""Serving engine: continuous batching with chunked prefill, driven by a
pluggable scheduler (Tempo or baselines) against a pluggable ``Backend``
(DESIGN.md §2).

``SimBackend`` (backend.py) — roofline-derived step-time model of a TPU v5e
serving replica (197 TFLOP/s, 819 GB/s HBM per chip): prefill time is
compute-bound, decode time is weight+KV HBM-bound.  This is what reproduces
the paper's figures at laptop scale.

``PagedJaxBackend`` (jax_backend.py) — a real reduced model decoding on
device against a paged KV cache addressed by this engine's ``BlockManager``
block tables; the SAME run loop below drives it.

The engine owns request lifecycle, KV block accounting (paged; page size
from the backend, default 128 tokens), collective-DAG stage spawning, and
SLO-tracker updates.  Time is the sum of backend step times plus arrival
gaps — a discrete-event loop at engine-step granularity, faithful to
iteration-level scheduling."""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import EngineView, SchedulerBase
from repro_torch.obs import NULL, NULL_TRACER
# SimBackend is re-exported here for backward compatibility — most callers
# still import it from repro.serving.engine.
from repro_torch.serving.backend import Backend, SimBackend  # noqa: F401
from repro_torch.serving.kvcache import (BLOCK_TOKENS, KV_BYTES_PER_TOKEN,
                                   BlockManager)
from repro_torch.serving.request import (CollectiveDag, ReqState, Request)
from repro_torch.serving.workload import WorkloadGen

# Accept-rate floor below which a request stops being granted draft depth
# (engine-level clamp in _spec_step; GMG's margin policy applies the same
# floor).  A rejected window costs its full width in forwards to emit one
# token, so a lane whose EWMA sits under the floor is a net loss.
SPEC_EWMA_FLOOR = 0.15


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 64
    prefill_budget: int = 2048        # tokens per step (chunked prefill)
    kv_blocks: int = 8192             # × 128 tokens ≈ 1M tokens of KV
    swap_bw: float = 60e9
    max_steps: int = 2_000_000
    # tensor-parallel degree of the replica's device mesh (DESIGN.md §8).
    # Threaded into PagedJaxBackend by the runners; the sim backend models
    # its chips explicitly and ignores it.  A KV-head-sharded replica's
    # pool is the mesh-wide aggregate (num_blocks scales ×tp).
    tp: int = 1
    fail_at: Optional[float] = None   # fault-tolerance drill (serve.py)
    # shared-prefix KV reuse (DESIGN.md §6).  Safe to leave on: requests
    # without meta['prompt_tokens'] have no prefix identity and bypass the
    # cache entirely, so legacy workloads are bit-for-bit unchanged.
    prefix_cache: bool = True
    # multi-step decode dispatch ceiling (DESIGN.md §10): on stable
    # decode-only steps the engine may run up to this many micro-steps in
    # ONE backend dispatch (further capped by the scheduler's horizon, the
    # next arrival, per-request remaining output, and KV headroom).  1 =
    # classic per-token dispatch; backends without supports_multi_step
    # ignore it.  Token streams are byte-identical across settings.
    decode_steps: int = 1
    # speculative decoding ceiling (DESIGN.md §11): max draft tokens a
    # decode lane may verify per step.  0 disables the spec path entirely;
    # otherwise the scheduler's spec_depth() grants per-lane depth up to
    # this cap (further clamped by remaining output and KV headroom for
    # the drafted window).  Token streams are byte-identical across
    # settings — speculation changes arrival TIMES, never token values.
    spec_depth_max: int = 0
    # replica role in a disaggregated fleet (DESIGN.md §12).  A SOFT role:
    # it steers the disagg router's placement and makes the cluster offer
    # prefill-complete requests for migration off "prefill" replicas —
    # the scheduler itself is role-blind, so a prefill replica that can't
    # migrate (no target, TTFT at risk) simply decodes locally, and a
    # DAG landed on any replica prefills there.  "mixed" (the default)
    # neither sheds decode work nor attracts migrations preferentially;
    # the autoscaler may flip a mixed replica's role under sustained
    # role imbalance.
    role: str = "mixed"          # "prefill" | "decode" | "mixed"
    # multi-tenant admission quota (fleet scale-out, DESIGN.md §13): cap
    # on a tenant's LIVE (admitted, unfinished) singles per unit of
    # fairness weight — tenant cap = ceil(tenant_quota × weight), with
    # weight from meta['tenant_weight'] (workload.TENANT_WEIGHT).  An
    # over-quota single is shed at admission and counts as an SLO miss in
    # the honest denominator.  0 disables admission control; untenanted
    # requests and DAG members are never admission-shed (collective
    # stages must complete once started).
    tenant_quota: int = 0


class ServeEngine:
    def __init__(self, backend, scheduler: SchedulerBase,
                 config: Optional[EngineConfig] = None,
                 workload: Optional[WorkloadGen] = None,
                 obs=None, tracer=None, replica: int = 0):
        self.backend = backend
        self.sched = scheduler
        # telemetry (DESIGN.md §9): disabled by default via the no-op
        # singletons.  Timestamps everywhere are the SIMULATED clock and
        # instrumentation never reads back into scheduling, so digests are
        # identical telemetry on/off.  The engine owns the handles and
        # rebinds them into the scheduler and backend so all three layers
        # report into one registry (in a cluster, a per-replica labeled
        # view of the fleet registry).
        self.replica = replica
        self.obs = obs if obs is not None else NULL
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trace = self.tracer.enabled
        scheduler.obs = self.obs
        scheduler.tracer = self.tracer
        scheduler.replica = replica
        if hasattr(backend, "attach_obs"):
            backend.attach_obs(self.obs)
        self._init_instruments()
        # NOTE: config must default to None — a dataclass instance in the
        # signature default would be shared across every engine, silently
        # coupling cluster replicas through one EngineConfig object.
        self.cfg = config if config is not None else EngineConfig()
        self.workload = workload
        # Block geometry follows the backend when it manages a real device
        # page pool (PagedJaxBackend); otherwise EngineConfig/defaults.
        # num_blocks/kv_bytes are the replica's MESH-WIDE aggregate: a
        # tp-sharded backend reports a pool tp× its per-device page budget
        # (each device holds a KV-head slice of every page), so EngineView
        # and the cluster's pressure signals price the whole mesh.
        self.kv = BlockManager(
            getattr(backend, "num_blocks", None) or self.cfg.kv_blocks,
            block_tokens=getattr(backend, "block_tokens", None)
            or BLOCK_TOKENS,
            kv_bytes_per_token=getattr(backend, "kv_bytes",
                                       KV_BYTES_PER_TOKEN),
            # the PAGE-split factor, not the mesh degree: a replicated-KV
            # fallback mesh (tp>1, kv_shard_degree=1) holds full pages
            # per device, so per-device block bytes must not shrink
            tp=getattr(backend, "kv_shard_degree", None) or self.cfg.tp)
        self.requests: Dict[int, Request] = {}
        self.dags: Dict[int, CollectiveDag] = {}
        self.finished: List[Request] = []
        # requests dropped by the scheduler (Decision.shed): lifecycle over,
        # KV released, finish_t stays None — the metrics layer counts them
        # (and anything else admitted-but-unfinished) as SLO misses
        self.shed: List[Request] = []
        self.now = 0.0
        self.step = 0
        # (t, prefill_tokens, decode_seqs, decode_ctx_total) per step — the
        # observation stream the SLOTracker's batch-aware cost model fits
        self.step_log: List[Tuple[float, int, int, int]] = []
        self.preempt_count = 0
        self.swap_bytes = 0.0
        # prefix-cache accounting (Summary.prefix_* / cached_frac)
        self.prefix_lookups = 0       # requests with a prefix identity
        self.prefix_hits = 0          # ... that matched cached pages
        self.cached_tokens = 0        # prompt tokens served from cache
        self.prefill_computed = 0     # prompt tokens actually computed
        self.cow_forks = 0            # shared pages forked before append
        # speculative decoding accounting (Summary.accept_rate)
        self.spec_proposed = 0        # draft tokens scored by verification
        self.spec_accepted = 0        # ... that matched the target's sample
        # signed (predicted − actual is negated: dt − pred) step-time
        # residuals of the tracker's StepCostModel, one per step where a
        # fit existed — Summary reports |residual| p50/p95
        self.cost_residuals: List[float] = []
        # live KV migration accounting (DESIGN.md §12): requests this
        # replica handed off after prefill / landed for decode
        self.migrated_out = 0
        self.migrated_in = 0
        # per-tenant live counts (admitted, unfinished) maintained
        # incrementally — the admission-quota check must stay O(1) at
        # fleet scale.  "" (untenanted) is never tracked.
        self.tenant_live: Dict[str, int] = {}
        self._pending: List[Tuple[float, int, object]] = []
        # in-flight migrations addressed to this replica: (arrive_t, seq,
        # Request, payload pkg).  Kept separate from _pending — routers
        # and queue metrics introspect pending_items() as ("r"/"dag")
        # arrival pairs and must not see half-transferred requests.
        self._inbound: List[Tuple[float, int, Request, dict]] = []
        self._seq = 0
        # last engine step's duration — the fast path's estimate of how
        # many micro-steps fit before the next pending arrival
        self._last_step_dt = 0.0

    def _init_instruments(self) -> None:
        """Resolve every hot-path instrument ONCE.  Under the no-op
        registry these all bind to the shared no-op instrument — zero
        entries are created and per-step record calls are empty method
        dispatches."""
        m = self.obs
        tb = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0)
        self._m_step = {
            k: m.histogram("engine_step_seconds",
                           "engine step wall-clock by phase mix",
                           buckets=tb, phase=k)
            for k in ("prefill", "decode", "mixed", "idle")}
        self._m_prefill_tok = m.histogram(
            "engine_step_prefill_tokens", "prefill tokens per step",
            buckets=(8, 32, 128, 512, 2048, 8192))
        self._m_decode_seqs = m.histogram(
            "engine_step_decode_seqs", "decode batch width per step",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_kv = m.gauge("engine_kv_used_frac",
                             "KV pool used fraction "
                             "(reclaimable cached blocks count as free)")
        self._m_preempt = m.counter("engine_preempt_total",
                                    "requests displaced from a slot")
        self._m_swap = m.counter("engine_swap_bytes_total",
                                 "KV bytes swapped to host")
        self._m_shed_c = m.counter("engine_shed_total",
                                   "requests dropped via Decision.shed")
        self._m_kv_blocked = m.counter(
            "engine_kv_blocked_steps_total",
            "steps where a KV allocation failed under pressure")
        self._m_admit = m.counter("engine_admitted_total",
                                  "requests admitted")
        self._m_finished = m.counter("engine_finished_total",
                                     "requests finished")
        self._m_prefix_hit = m.counter("engine_prefix_hits_total",
                                       "prefix-cache hits at admit")
        self._m_cached_tok = m.counter(
            "engine_cached_tokens_total",
            "prompt tokens served from the prefix cache")
        self._m_resid = m.histogram(
            "engine_cost_residual_seconds",
            "abs(step-time cost-model prediction - actual)", buckets=tb)
        self._m_spec_prop = m.counter(
            "engine_spec_proposed_total",
            "draft tokens scored by speculative verification")
        self._m_spec_acc = m.counter(
            "engine_spec_accepted_total",
            "draft tokens accepted (matched the target's own sample)")
        self._m_migrated_out = m.counter(
            "engine_migrated_out_total",
            "requests handed off to a decode replica after prefill")
        self._m_migrated_in = m.counter(
            "engine_migrated_in_total",
            "migrated requests landed on this replica for decode")
        self._m_spec_rate = m.histogram(
            "engine_spec_accept_rate",
            "per-lane draft accept rate per verify step",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self._m_ttft = {
            k: m.histogram("engine_ttft_seconds", "time to first token",
                           buckets=(0.01, 0.03, 0.1, 0.3, 1, 3, 10, 30,
                                    100), slo=k)
            for k in ("latency", "throughput", "collective", "none")}
        self._m_tpot = {
            k: m.histogram("engine_tpot_seconds",
                           "mean time per output token at finish",
                           buckets=tb, slo=k)
            for k in ("latency", "throughput", "collective", "none")}
        # per-tenant lifecycle counters, created lazily on first use so
        # untenanted runs register no extra series
        self._tenant_ins: Dict[Tuple[str, str], object] = {}

    _TENANT_HELP = {
        "admitted": "requests admitted, by tenant class",
        "finished": "requests finished, by tenant class",
        "shed": "requests shed (scheduler or admission quota), by tenant",
        "quota_shed": "requests rejected by the admission quota, by tenant",
    }

    def _m_tenant(self, which: str, tenant: str):
        key = (which, tenant)
        ins = self._tenant_ins.get(key)
        if ins is None:
            ins = self.obs.counter(f"engine_tenant_{which}_total",
                                   self._TENANT_HELP[which], tenant=tenant)
            self._tenant_ins[key] = ins
        return ins

    # ------------------------------------------------------------------
    def load(self, singles: List[Request],
             dags: List[Tuple[CollectiveDag, List[Request]]]):
        for r in singles:
            self.enqueue("r", r)
        for dag, reqs in dags:
            self.enqueue("dag", (dag, reqs))

    def enqueue(self, kind: str, obj) -> None:
        """Queue one future arrival: ("r", Request) or
        ("dag", (CollectiveDag, stage0 requests)).  Cluster routers call
        this to dispatch events onto a replica mid-simulation."""
        t = obj.arrival if kind == "r" else obj[0].arrival
        self._seq += 1
        heapq.heappush(self._pending, (t, self._seq, (kind, obj)))

    # ------------------------------------------------------------------
    def _tracker(self):
        return getattr(self.sched, "tracker", None)

    def _quota_reject(self, req: Request) -> bool:
        """Admission-quota check (O(1)): a tenanted single over its live
        cap is rejected under admission control.  DAG members pass — a
        collective's stages must complete once stage 0 is admitted."""
        q = self.cfg.tenant_quota
        if not q or not req.tenant or req.dag_id is not None:
            return False
        cap = math.ceil(q * float(req.meta.get("tenant_weight", 1.0)))
        return self.tenant_live.get(req.tenant, 0) >= max(cap, 1)

    def _tenant_done(self, r: Request, shed: bool = False) -> None:
        if not r.tenant:
            return
        n = self.tenant_live.get(r.tenant, 0) - 1
        self.tenant_live[r.tenant] = max(n, 0)
        self._m_tenant("shed" if shed else "finished", r.tenant).inc(
            t=self.now)

    def _admit(self, req: Request):
        self.requests[req.rid] = req
        self._m_admit.inc(t=self.now)
        if req.tenant:
            self._m_tenant("admitted", req.tenant).inc(t=self.now)
        if self._trace:
            self.tracer.event("admit", req.rid, self.now, self.replica,
                              slo=req.slo.kind, prompt_len=req.prompt_len,
                              arrival=round(req.arrival, 6))
        if self._quota_reject(req):
            # lifecycle over before scheduling: no KV was touched, the
            # scheduler never sees it, and the honest denominator still
            # counts it (requests dict + shed list -> SLO miss)
            req.state = ReqState.FINISHED
            self.shed.append(req)
            self._m_shed_c.inc(t=self.now)
            self._m_tenant("shed", req.tenant).inc(t=self.now)
            self._m_tenant("quota_shed", req.tenant).inc(t=self.now)
            if self._trace:
                self.tracer.event("shed", req.rid, self.now, self.replica,
                                  prefilled=0, decoded=0, reason="quota")
            return
        if req.tenant:
            self.tenant_live[req.tenant] = \
                self.tenant_live.get(req.tenant, 0) + 1
        if self.cfg.prefix_cache:
            self._prefix_lookup(req)
        view = self._view()
        self.sched.on_arrival(req, view)

    # ------------------------------------------------------------------
    # Shared-prefix KV reuse (DESIGN.md §6)
    # ------------------------------------------------------------------
    def _prefix_lookup(self, req: Request) -> None:
        """Longest-cached-prefix lookup at admit: adopt the hit pages and
        charge prefill only for the uncached suffix.  The match is capped
        at prompt_len-1 so every request computes ≥1 suffix token — its
        first write lands behind a COW fork, never inside a shared page."""
        toks = req.meta.get("prompt_tokens")
        if toks is None or req.rid in self.kv.seqs:
            return
        self.prefix_lookups += 1
        blocks, cached = self.kv.match(toks, max_tokens=req.prompt_len - 1)
        if cached <= 0:
            return
        self.kv.adopt(req.rid, blocks, cached)
        req.cached_len = cached
        req.prefilled = cached
        self.prefix_hits += 1
        self.cached_tokens += cached
        self._m_prefix_hit.inc(t=self.now)
        self._m_cached_tok.inc(cached, t=self.now)
        if self._trace:
            self.tracer.event("prefix_match", req.rid, self.now,
                              self.replica, cached=cached)

    def _prefix_register(self, req: Request) -> None:
        """Publish a finished request's pages into the prefix index.  The
        registered content is prompt + generated output MINUS the final
        sampled token — its KV slot is never written (the step that would
        write it never runs), so it must not be claimed as cached."""
        toks = req.meta.get("prompt_tokens")
        if toks is None:
            return
        out = self.backend.output_tokens(req.rid)
        if out is None:
            out = req.meta.get("output_tokens")
        ctx = np.asarray(toks, np.int64)
        if out is not None and len(out) > 0:
            ctx = np.concatenate([ctx, np.asarray(out, np.int64)])
        n_written = req.prompt_len + req.decoded - 1
        # the prompt boundary is registered as an extra tail: real-backend
        # followers extend the PROMPT, not the (unknowable) generated text
        self.kv.register(req.rid, ctx[:n_written],
                         boundaries=(req.prompt_len,))

    def _cow_fork(self, rid: int, pos: int, protect: set) -> bool:
        """Make the page holding `pos` privately writable (copy-on-write),
        evicting for a fresh block if the pool is exhausted."""
        res = self.kv.fork_for_append(rid, pos)
        if res is None:
            if not self._evict_for(self.kv.block_tokens, protect):
                return False
            res = self.kv.fork_for_append(rid, pos)
            if res is None:
                return False
        old, new = res
        if old != new:
            self.backend.kv_copy_page(old, new)
            self.cow_forks += 1
        return True

    def _view(self) -> EngineView:
        return EngineView(
            now=self.now, step=self.step, requests=self.requests,
            max_batch=self.cfg.max_batch,
            prefill_budget=self.cfg.prefill_budget,
            kv_block_bytes=int(self.kv.kv_bytes_per_token
                               * self.kv.block_tokens),
            block_tokens=self.kv.block_tokens,
            swap_bw=self.cfg.swap_bw,
            kv_free_frac=self.kv.available_frac,
            dag_remaining=self._dag_remaining)

    def _dag_remaining(self, rid: int) -> float:
        """Max estimated remaining time across the request's stage siblings
        (finishing one early doesn't finish the stage)."""
        r = self.requests.get(rid)
        tr = self._tracker()
        if r is None or r.dag_id is None or tr is None:
            return 0.0
        best = 0.0
        for sib in self.requests.values():
            if sib.dag_id == r.dag_id and sib.stage == r.stage \
                    and sib.state != ReqState.FINISHED:
                ub = sib.pred_upper or sib.true_output_len
                best = max(best, tr.est_remaining_time(sib, ub))
        return best

    # ------------------------------------------------------------------
    # Narrow stepping interface (also drives cluster co-simulation)
    # ------------------------------------------------------------------
    def has_live(self) -> bool:
        return any(r.state != ReqState.FINISHED
                   for r in self.requests.values())

    @property
    def admitted_count(self) -> int:
        """Every request ever admitted (finished + live + shed)."""
        return len(self.requests)

    @property
    def submitted_count(self) -> int:
        """The honest goodput denominator: admitted requests, queued
        not-yet-admitted arrivals, AND the planned-but-unspawned stages
        of unfinished DAGs (stage n+1 only materialises when stage n
        completes — truncating a run mid-DAG must not let the unspawned
        tail vanish from goodput_frac).  Equals admitted_count for a
        fully drained run."""
        n = len(self.requests) + len(self._inbound)
        for kind, obj in self.pending_items():
            if kind == "r":
                n += 1
            else:
                dag, reqs = obj
                n += len(reqs) + sum(dag.stage_sizes[1:])
        for dag in self.dags.values():
            if not dag.finished:
                n += sum(dag.stage_sizes[dag.cur_stage + 1:])
        return n

    def tenant_submitted(self) -> Dict[str, int]:
        """Per-tenant slice of ``submitted_count`` ("" = untenanted) —
        the honest per-tenant goodput denominators."""
        n: Dict[str, int] = {}

        def add(tenant: str, k: int = 1) -> None:
            n[tenant] = n.get(tenant, 0) + k

        for r in self.requests.values():
            add(r.tenant)
        for _, _, r, _ in self._inbound:
            add(r.tenant)
        for kind, obj in self.pending_items():
            if kind == "r":
                add(obj.tenant)
            else:
                dag, reqs = obj
                add(dag.tenant, len(reqs) + sum(dag.stage_sizes[1:]))
        for dag in self.dags.values():
            if not dag.finished:
                add(dag.tenant, sum(dag.stage_sizes[dag.cur_stage + 1:]))
        return n

    def _next_arrival_t(self) -> Optional[float]:
        """Earliest queued event — a workload arrival or an in-flight
        migration landing — or None when both queues are empty."""
        ts = []
        if self._pending:
            ts.append(self._pending[0][0])
        if self._inbound:
            ts.append(self._inbound[0][0])
        return min(ts) if ts else None

    def peek_next_event(self) -> Optional[float]:
        """Earliest time this engine can make progress: its own clock while
        requests are live, else the next queued arrival; None when idle.
        Never earlier than the engine's own clock — a cold-starting replica
        (clock pre-advanced past spawn) cannot serve an arrival queued
        before it booted."""
        if self.has_live():
            return self.now
        t = self._next_arrival_t()
        if t is not None:
            return max(t, self.now)
        return None

    def pending_items(self) -> List[Tuple[str, object]]:
        """Queued not-yet-admitted arrivals as (kind, obj) pairs — the
        public view of the arrival queue for cluster routers/metrics."""
        return [(kind, obj) for _, _, (kind, obj) in self._pending]

    def admit_arrived(self) -> None:
        """Admit every queued arrival whose time has been reached, and land
        every in-flight migration whose transfer has completed."""
        while self._pending and self._pending[0][0] <= self.now:
            _, _, (kind, obj) = heapq.heappop(self._pending)
            if kind == "r":
                self._admit(obj)
            else:
                dag, reqs = obj
                self.dags[dag.dag_id] = dag
                self._on_stage_start(dag, reqs, stage=0)
        while self._inbound and self._inbound[0][0] <= self.now:
            _, _, req, pkg = heapq.heappop(self._inbound)
            self.handoff_in(req, pkg)

    def step_once(self) -> bool:
        """Admit arrivals, jump the clock over an idle gap if needed, and
        run ONE scheduler step.  Returns False when out of work/steps."""
        if self.step >= self.cfg.max_steps:
            return False
        self.admit_arrived()
        if not self.has_live():
            t = self._next_arrival_t()
            if t is None:
                return False
            self.now = max(self.now, t)
            self.admit_arrived()
            if not self.has_live():
                return False
        self._execute(self.sched.schedule(self._view()))
        return True

    # ------------------------------------------------------------------
    def run(self, until: Optional[float] = None, drain: bool = True):
        while self.step < self.cfg.max_steps:
            self.admit_arrived()
            if not self.has_live():
                t = self._next_arrival_t()
                if t is not None and (until is None or t < until):
                    self.now = max(self.now, t)
                    continue
                break
            if until is not None and self.now >= until and not drain:
                break
            self._execute(self.sched.schedule(self._view()))
        return self.finished

    # ------------------------------------------------------------------
    # Live KV migration (DESIGN.md §12): handoff_out / handoff_in
    # ------------------------------------------------------------------
    def enqueue_handoff(self, req: Request, pkg: dict, t: float) -> None:
        """Queue a migrated request to land at time `t` (when its KV
        transfer completes).  The cluster calls this on the destination
        right after the source's handoff_out."""
        self._seq += 1
        heapq.heappush(self._inbound, (t, self._seq, req, pkg))

    @property
    def inbound_count(self) -> int:
        return len(self._inbound)

    def handoff_out(self, rid: int):
        """Extract a live prefill-complete request for migration.  Returns
        (req, pkg) — pkg bundles the backend's exported KV payload plus
        size accounting for transfer pricing — or None when the request
        is not in a migratable state (mid-prefill, already decoding as a
        DAG stage, swapped out, or gone).  The request leaves this replica
        entirely: its prompt pages are first published into the local
        prefix index (followers still hit the prefill this replica paid
        for — the export gathered a copy, so the device pages stay valid),
        then KV and backend state are released and the rid is removed from
        `requests`, so this replica's goodput denominator no longer counts
        it; the destination's does, exactly once fleet-wide."""
        r = self.requests.get(rid)
        a = self.kv.seqs.get(rid)
        if (r is None or r.done or r.state == ReqState.FINISHED
                or r.dag_id is not None or r.prefill_remaining > 0
                or a is None or a.swapped):
            return None
        payload = self.backend.kv_export_pages(rid, self.kv.block_table(rid))
        pkg = dict(pages=payload, tokens=a.tokens, n_pages=len(a.blocks),
                   bytes=a.tokens * self.kv.kv_bytes_per_token)
        toks = r.meta.get("prompt_tokens")
        if self.cfg.prefix_cache and toks is not None and r.decoded == 0 \
                and a.tokens == r.prompt_len:
            # every prompt position was written during prefill, so the
            # full prompt is registrable content (unlike a finished
            # request, whose final sampled token's slot is never written)
            self.kv.register(rid, np.asarray(toks, np.int64)[:a.tokens])
        self.kv.release(rid)
        self.backend.kv_release(rid)
        del self.requests[rid]
        r.state = ReqState.WAITING
        if r.tenant:   # leaves this replica's live set (lands on dst's)
            self.tenant_live[r.tenant] = max(
                self.tenant_live.get(r.tenant, 0) - 1, 0)
        self.migrated_out += 1
        self._m_migrated_out.inc(t=self.now)
        if self._trace:
            self.tracer.event("handoff_out", rid, self.now, self.replica,
                              tokens=a.tokens)
        return r, pkg

    def handoff_in(self, req: Request, pkg: dict) -> None:
        """Land a migrated request: materialize destination pages, import
        the KV payload, and hand the request to the scheduler.  It arrives
        with prefill complete — no prefill is recomputed and no
        prefix-cache credit is claimed, so this replica's Summary counts
        only the decode work it actually does.  Under pool pressure the
        payload parks as swapped-out host state and the ordinary swap-in
        path (`_ensure_kv`) restores it byte-exactly later."""
        rid = req.rid
        assert rid not in self.requests, f"r{rid} already on this replica"
        n_tok = int(pkg["tokens"])
        n_pages = int(pkg.get("n_pages")
                      or -(-n_tok // self.kv.block_tokens))
        req.state = ReqState.WAITING
        req.meta["migrated"] = True
        self.requests[rid] = req
        if req.tenant:
            self.tenant_live[req.tenant] = \
                self.tenant_live.get(req.tenant, 0) + 1
        self.migrated_in += 1
        self._m_migrated_in.inc(t=self.now)
        ok = self.kv.adopt(rid, n_pages, n_tok)
        if not ok and self._evict_for(n_tok, {rid}):
            ok = self.kv.adopt(rid, n_pages, n_tok)
        if ok:
            self.backend.kv_import_pages(rid, pkg["pages"],
                                         self.kv.block_table(rid))
        else:
            # no room even after eviction: park host-side as swapped-out
            self.kv.park_swapped(rid, n_tok)
            self.backend.kv_import_pages(rid, pkg["pages"], None)
        if self._trace:
            self.tracer.event("handoff_in", rid, self.now, self.replica,
                              tokens=n_tok, resident=int(ok))
        self.sched.on_arrival(req, self._view())

    # ------------------------------------------------------------------
    def _on_stage_start(self, dag: CollectiveDag, reqs: List[Request],
                        stage: int):
        total_in = sum(r.prompt_len for r in reqs)
        hook = getattr(self.sched, "dag_tracker", None)
        if hook is not None:
            hook.on_stage_start(dag.dag_id, dag.app, self.now,
                                len(reqs), total_in)
        # stage deadline budgeting (Tempo); others keep the e2e deadline
        deadline = None
        if hook is not None and getattr(self.sched, "use_graph", False):
            partial = hook.partials.get(dag.dag_id)
            if partial is not None:
                deadline, _ = self.sched.matcher.stage_budget(
                    partial, self.now, dag.deadline, self.now - dag.arrival)
        if getattr(self.sched, "precise", False):
            # oracle: even split over the TRUE remaining stage count
            rem = len(dag.stage_sizes) - stage
            deadline = self.now + max(dag.deadline - self.now, 1e-3) / max(
                rem, 1)
        for r in reqs:
            if deadline is not None:
                r.stage_deadline = deadline
            self._admit(r)
        dag.cur_stage = stage

    def _maybe_advance_dag(self, req: Request):
        dag = self.dags.get(req.dag_id)
        if dag is None:
            return
        hook = getattr(self.sched, "dag_tracker", None)
        if hook is not None:
            hook.on_request_done(dag.dag_id, req.prompt_len,
                                 req.true_output_len)
        # stage finished?
        stage_live = [r for r in self.requests.values()
                      if r.dag_id == dag.dag_id and r.stage == dag.cur_stage
                      and r.state != ReqState.FINISHED]
        if stage_live:
            return
        if hook is not None:
            hook.on_stage_end(dag.dag_id, self.now)
        nxt = dag.cur_stage + 1
        if nxt < len(dag.stage_sizes):
            reqs = self.workload.spawn_stage(dag, nxt, self.now) \
                if self.workload else []
            if reqs:
                self._on_stage_start(dag, reqs, stage=nxt)
                return
        dag.finished = True
        dag.finish_t = self.now
        if hook is not None:
            hook.on_dag_done(dag.dag_id, self.now)

    # ------------------------------------------------------------------
    def _evict_for(self, tokens_needed: int, protect: set) -> bool:
        """Swap out preempted/idle sequences' KV until `tokens_needed` fit.
        Returns False if impossible.  Swap cost is charged to the step."""
        victims = sorted(
            (r for r in self.requests.values()
             if r.rid in self.kv.seqs and r.rid not in protect
             and r.state in (ReqState.PREEMPTED, ReqState.WAITING)),
            key=lambda r: -(r.prompt_len + r.decoded))
        for v in victims:
            if self.kv.can_fit(tokens_needed):
                return True
            moved = self._swap_out(v.rid)
            self.swap_bytes += moved
            self._step_swap += moved
        return self.kv.can_fit(tokens_needed)

    def _swap_out(self, rid: int) -> float:
        """Swap one sequence's KV out, telling the backend FIRST (it must
        copy the device pages before the blocks are recycled)."""
        a = self.kv.seqs.get(rid)
        if a is not None and not a.swapped:
            self.backend.kv_swap_out(rid, self.kv.block_table(rid), a.tokens)
        moved = self.kv.swap_out(rid)
        self._m_swap.inc(moved, t=self.now)
        return moved

    def _ensure_kv(self, rid: int, tokens: int, protect: set) -> bool:
        r = self.requests[rid]
        alloc = self.kv.seqs.get(rid)
        if alloc is not None and alloc.swapped:
            cost = self.kv.swap_in(rid)
            if cost is None:
                if not self._evict_for(alloc.tokens, protect):
                    return False
                cost = self.kv.swap_in(rid)
            self._step_swap += cost or 0.0
            if not self.kv.seqs[rid].swapped:
                self.backend.kv_swap_in(rid, self.kv.block_table(rid))
                if self._trace:
                    self.tracer.event("swap_in", rid, self.now,
                                      self.replica)
        if self.kv.ensure(rid, tokens):
            return True
        if not self._evict_for(tokens, protect):
            return False
        return self.kv.ensure(rid, tokens)

    def _force_evict(self) -> None:
        """Deadlock breaker: every KV holder was protected this step and an
        allocation failed, so no request can grow and the engine would spin
        burning only overhead.  Swap out the newest-arrival resident
        sequence (vLLM-style preempt-newest) so older work can progress;
        the victim swaps back in once blocks free up."""
        victims = [r for r in self.requests.values()
                   if r.state != ReqState.FINISHED
                   and r.rid in self.kv.seqs
                   and self.kv.seqs[r.rid].blocks
                   and not self.kv.seqs[r.rid].swapped]
        if not victims:
            return
        v = max(victims, key=lambda r: (r.arrival, r.rid))
        moved = self._swap_out(v.rid)
        self.swap_bytes += moved
        self._step_swap += moved
        if v.state in (ReqState.RUNNING, ReqState.PREFILL):
            v.state = ReqState.PREEMPTED
            v.preemptions += 1
            self.preempt_count += 1
            self._m_preempt.inc(t=self.now)
            if self._trace:
                self.tracer.event("preempt", v.rid, self.now, self.replica,
                                  forced=1)

    def _execute(self, dec):
        self._step_swap = 0.0
        self._kv_blocked = False
        self.backend.begin_step()
        # shed requests: dropped outright (scheduler decided the §3.1 decay
        # left nothing worth serving and KV is under pressure).  Blocks are
        # released BEFORE this step's allocations so the freed pages are
        # usable immediately.
        for rid in getattr(dec, "shed", ()):
            r = self.requests.get(rid)
            if r is None or r.state == ReqState.FINISHED:
                continue
            r.state = ReqState.FINISHED
            self.kv.release(rid)
            self.backend.kv_release(rid)
            self.shed.append(r)
            self._m_shed_c.inc(t=self.now)
            self._tenant_done(r, shed=True)
            if self._trace:
                self.tracer.event("shed", rid, self.now, self.replica,
                                  prefilled=r.prefilled, decoded=r.decoded)
        # displaced requests: slot lost; KV stays resident until pressure
        for rid in dec.preempted:
            r = self.requests.get(rid)
            if r and r.state in (ReqState.RUNNING, ReqState.PREFILL):
                r.state = ReqState.PREEMPTED
                r.preemptions += 1
                self.preempt_count += 1
                self._m_preempt.inc(t=self.now)
                if self._trace:
                    self.tracer.event("preempt", rid, self.now,
                                      self.replica)

        protect = set(dec.decode_ids) | set(dec.prefill)
        prefill_tokens = 0
        for rid, chunk in dec.prefill.items():
            r = self.requests.get(rid)
            if r is None or r.state == ReqState.FINISHED:
                continue
            chunk = min(chunk, r.prefill_remaining)
            if chunk <= 0:
                continue
            if not self._ensure_kv(rid, r.prefilled + chunk, protect):
                self._kv_blocked = True
                continue  # KV pressure: skip this chunk
            # the chunk's first page may be a shared cached page (a
            # partially-filled tail adopted at admit): fork it before
            # writing so sharers and the index never see a mutation
            if not self._cow_fork(rid, r.prefilled, protect):
                self._kv_blocked = True
                continue
            self.backend.prefill_chunk(r, r.prefilled, chunk,
                                       self.kv.block_table(rid))
            r.prefilled += chunk
            r.state = ReqState.PREFILL
            prefill_tokens += chunk
            self.prefill_computed += chunk
            if self._trace:
                self.tracer.event("prefill_chunk", rid, self.now,
                                  self.replica, chunk=chunk,
                                  prefilled=r.prefilled)

        decode_ctxs = []
        decoded_reqs = []
        decode_tables = []
        for rid in dec.decode_ids:
            r = self.requests.get(rid)
            if r is None or r.state == ReqState.FINISHED or \
                    r.prefill_remaining > 0 or r.done:
                continue
            ctx = r.prompt_len + r.decoded
            if not self._ensure_kv(rid, ctx + 1, protect):
                self._kv_blocked = True
                continue
            r.state = ReqState.RUNNING
            decode_ctxs.append(ctx)
            decoded_reqs.append(r)
            decode_tables.append(self.kv.block_table(rid))

        if not prefill_tokens and not decode_ctxs and self._kv_blocked:
            self._force_evict()

        if self._spec_step(decoded_reqs, decode_ctxs, prefill_tokens,
                           protect):
            return

        n = self._decode_horizon(dec, decoded_reqs, prefill_tokens, protect)
        if n > 1:
            # the horizon pre-allocated n tokens of block headroom per
            # lane, which may have grown the tables — re-read them
            decode_tables = [self.kv.block_table(r.rid)
                             for r in decoded_reqs]
            _, act_n = self.backend.decode_batch_n(decoded_reqs,
                                                   decode_tables, n)
            self._account_multi_step(decoded_reqs, decode_ctxs, act_n, n)
            return

        self.backend.decode_batch(decoded_reqs, decode_tables)

        dt = self.backend.step_time(prefill_tokens, decode_ctxs)
        dt += self._step_swap / self.cfg.swap_bw
        self._last_step_dt = dt
        self.now += dt
        self.step += 1
        ctx_total = sum(decode_ctxs)
        self.step_log.append((self.now, prefill_tokens, len(decoded_reqs),
                              ctx_total))
        phase = ("mixed" if prefill_tokens and decode_ctxs else
                 "prefill" if prefill_tokens else
                 "decode" if decode_ctxs else "idle")
        self._m_step[phase].observe(dt, t=self.now)
        self._m_prefill_tok.observe(prefill_tokens, t=self.now)
        self._m_decode_seqs.observe(len(decoded_reqs), t=self.now)
        self._m_kv.set(1.0 - self.kv.available_frac, t=self.now)
        if self._kv_blocked:
            self._m_kv_blocked.inc(t=self.now)
        tr = self._tracker()
        if tr is not None:
            # prediction-vs-actual residual of the model fitted on PRIOR
            # steps (predict before on_step folds this step in)
            cm = getattr(tr, "cost_model", None)
            pred = cm.predict(prefill_tokens, len(decoded_reqs),
                              float(ctx_total)) if cm is not None else None
            if pred is not None:
                self.cost_residuals.append(dt - pred)
                self._m_resid.observe(abs(dt - pred), t=self.now)
            tr.on_step(dt, prefill_tokens, len(decoded_reqs),
                       float(ctx_total))

        finished_now = []
        for r in decoded_reqs:
            r.decoded += 1
            r.token_times.append(self.now)
            if r.first_token_t is None:
                r.first_token_t = self.now
                self._m_ttft[r.slo.kind].observe(self.now - r.arrival,
                                                 t=self.now)
                if self._trace:
                    self.tracer.event("first_token", r.rid, self.now,
                                      self.replica)
            if r.done:
                r.state = ReqState.FINISHED
                r.finish_t = self.now
                if self.cfg.prefix_cache:
                    self._prefix_register(r)
                self.kv.release(r.rid)
                self.backend.kv_release(r.rid)
                self.finished.append(r)
                finished_now.append(r)
                self._m_finished.inc(t=self.now)
                self._tenant_done(r)
                if r.decoded > 1 and r.first_token_t is not None:
                    self._m_tpot[r.slo.kind].observe(
                        (self.now - r.first_token_t) / (r.decoded - 1),
                        t=self.now)
                if self._trace:
                    self.tracer.event("finish", r.rid, self.now,
                                      self.replica, decoded=r.decoded)
        for r in finished_now:
            self.sched.on_finish(r, self._view())
            if r.dag_id is not None:
                self._maybe_advance_dag(r)

    # ------------------------------------------------------------------
    # speculative decoding (DESIGN.md §11)
    # ------------------------------------------------------------------
    def _spec_step(self, decoded_reqs, decode_ctxs, prefill_tokens,
                   protect) -> bool:
        """Draft-then-verify fast path: one engine step that may emit
        several tokens per lane.  Engages on decode-only steps when the
        config ceiling is nonzero, the backend supports verification, and
        the scheduler grants at least one lane a nonzero depth; unlike
        the multi-step scan it runs exactly ONE scheduler decision, so it
        needs no batch-stability conditions.  Depth per lane is
        min(scheduler grant, spec_depth_max, remaining-1), then the
        drafted window's KV is pre-allocated — a lane that can't grow
        falls back to depth 0 and rides along as a plain decode row.
        After verification, rejected draft KV is rolled back by dropping
        page refs (BlockManager.truncate); stale within-page writes are
        ctx-masked and overwritten by the sequential path later."""
        if (self.cfg.spec_depth_max < 1 or not decoded_reqs
                or prefill_tokens
                or not getattr(self.backend, "supports_spec_decode",
                               False)):
            return False
        grants = self.sched.spec_depth(self._view())
        depths = []
        for r in decoded_reqs:
            d = grants.get(r.rid, self.cfg.spec_depth_max)
            # engine-level accept-rate guard, scheduler-agnostic: a lane
            # the drafter keeps missing on pays a whole multi-token
            # forward per emitted token, so once its EWMA falls below the
            # floor it stops speculating regardless of policy (GMG applies
            # the same gate inside its margin policy; FCFS/tempo get it
            # only here)
            ew = r.spec_accept_ewma
            if ew is not None and ew < SPEC_EWMA_FLOOR:
                d = 0
            depths.append(max(0, min(d, self.cfg.spec_depth_max,
                                     r.true_output_len - r.decoded - 1)))
        if not any(depths):
            return False
        for i, r in enumerate(decoded_reqs):
            if depths[i] and not self._ensure_kv(
                    r.rid, r.prompt_len + r.decoded + 1 + depths[i],
                    protect):
                depths[i] = 0       # window doesn't fit: plain decode row
        if not any(depths):
            return False
        if self._trace:
            for r, d in zip(decoded_reqs, depths):
                if d:
                    self.tracer.event("spec_draft", r.rid, self.now,
                                      self.replica, depth=d)
        tables = [self.kv.block_table(r.rid) for r in decoded_reqs]
        results = self.backend.decode_verify_batch(decoded_reqs, tables,
                                                   depths)
        vtok = sum(p for _, _, p in results)
        for r, (e, _a, _p) in zip(decoded_reqs, results):
            self.kv.truncate(r.rid, r.prompt_len + r.decoded + e)
        self._account_spec_step(decoded_reqs, decode_ctxs, results, vtok)
        for r, (e, a, p) in zip(decoded_reqs, results):
            if p <= 0:
                continue
            self.spec_proposed += p
            self.spec_accepted += a
            self._m_spec_prop.inc(p, t=self.now)
            self._m_spec_acc.inc(a, t=self.now)
            rate = a / p
            self._m_spec_rate.observe(rate, t=self.now)
            if r.spec_accept_ewma is None:
                r.spec_accept_ewma = rate
            else:
                r.spec_accept_ewma += 0.3 * (rate - r.spec_accept_ewma)
            if self._trace:
                self.tracer.event("spec_verify", r.rid, self.now,
                                  self.replica, proposed=p, accepted=a,
                                  emitted=e)
        return True

    def _account_spec_step(self, decoded_reqs, decode_ctxs, results,
                           vtok: int) -> None:
        """SLO accounting for one verify dispatch.  The cost model sees
        the step as it ran — ONE observation with the verify-token
        feature — while the clock/token artifacts are split into
        max(emitted) micro-steps exactly like the multi-step scan: lane i
        emits at micro-steps 0..emitted_i-1, so TTFT/TBT/token_times land
        on the same evenly-spaced timeline a sequential dispatch of those
        tokens would produce."""
        dt_total = self.backend.step_time(0, decode_ctxs,
                                          verify_tokens=vtok)
        dt_total += self._step_swap / self.cfg.swap_bw
        m = max(e for e, _, _ in results)
        dt_each = dt_total / m
        self._last_step_dt = dt_each
        tr = self._tracker()
        ctx_total = sum(decode_ctxs)
        if tr is not None:
            cm = getattr(tr, "cost_model", None)
            pred = cm.predict(0, len(decoded_reqs), float(ctx_total),
                              verify_tokens=vtok) if cm is not None \
                else None
            if pred is not None:
                self.cost_residuals.append(dt_total - pred)
                self._m_resid.observe(abs(dt_total - pred), t=self.now)
            tr.on_step(dt_total, 0, len(decoded_reqs), float(ctx_total),
                       verify_tokens=vtok)
        finished_now = []
        for s in range(m):
            act = [r for r, (e, _, _) in zip(decoded_reqs, results)
                   if s < e]
            if not act:
                break
            self.now += dt_each
            self.step += 1
            self.step_log.append((self.now, 0, len(act),
                                  sum(r.prompt_len + r.decoded
                                      for r in act)))
            self._m_step["decode"].observe(dt_each, t=self.now)
            self._m_prefill_tok.observe(0, t=self.now)
            self._m_decode_seqs.observe(len(act), t=self.now)
            self._m_kv.set(1.0 - self.kv.available_frac, t=self.now)
            for r in act:
                r.decoded += 1
                r.token_times.append(self.now)
                if r.first_token_t is None:
                    r.first_token_t = self.now
                    self._m_ttft[r.slo.kind].observe(self.now - r.arrival,
                                                     t=self.now)
                    if self._trace:
                        self.tracer.event("first_token", r.rid, self.now,
                                          self.replica)
                if r.done:
                    r.state = ReqState.FINISHED
                    r.finish_t = self.now
                    if self.cfg.prefix_cache:
                        self._prefix_register(r)
                    self.kv.release(r.rid)
                    self.backend.kv_release(r.rid)
                    self.finished.append(r)
                    finished_now.append(r)
                    self._m_finished.inc(t=self.now)
                    self._tenant_done(r)
                    if r.decoded > 1 and r.first_token_t is not None:
                        self._m_tpot[r.slo.kind].observe(
                            (self.now - r.first_token_t) / (r.decoded - 1),
                            t=self.now)
                    if self._trace:
                        self.tracer.event("finish", r.rid, self.now,
                                          self.replica, decoded=r.decoded)
        for r in finished_now:
            self.sched.on_finish(r, self._view())
            if r.dag_id is not None:
                self._maybe_advance_dag(r)

    # ------------------------------------------------------------------
    # multi-step decode fast path (DESIGN.md §10)
    # ------------------------------------------------------------------
    def _decode_horizon(self, dec, decoded_reqs, prefill_tokens,
                        protect) -> int:
        """How many decode micro-steps may safely run in one dispatch.

        Engages only on STABLE decode-only steps: no prefill, preemption,
        shedding, or KV pressure this step, and every live request is in
        the decode batch — a waiting, paced, or JIT-deferred request means
        the scheduler wants to revisit its decision next step, so the fast
        path stands down.  The horizon is then the minimum of the
        configured ceiling, the scheduler's own horizon (e.g. the next
        quanta boundary), the steps left before max_steps, the smallest
        remaining output (a finish re-opens a batch slot), and the steps
        estimated to fit before the next pending arrival; finally the
        whole window's KV is pre-allocated so no block allocation can be
        needed mid-scan."""
        n_cfg = self.cfg.decode_steps
        if (n_cfg <= 1 or not decoded_reqs
                or not getattr(self.backend, "supports_multi_step", False)):
            return 1
        if (prefill_tokens or dec.prefill or dec.preempted
                or getattr(dec, "shed", ()) or self._kv_blocked):
            return 1
        in_batch = {r.rid for r in decoded_reqs}
        for r in self.requests.values():
            if r.state != ReqState.FINISHED and r.rid not in in_batch:
                return 1
        n = min(n_cfg, int(self.sched.decode_horizon(self._view())),
                self.cfg.max_steps - self.step,
                min(r.true_output_len - r.decoded for r in decoded_reqs))
        if self._pending:
            gap = self._pending[0][0] - self.now
            est = self._last_step_dt
            if gap <= 0 or est <= 0:
                return 1
            n = min(n, max(1, int(gap / est)))
        if n <= 1:
            return 1
        for r in decoded_reqs:
            if not self._ensure_kv(r.rid, r.prompt_len + r.decoded + n,
                                   protect):
                return 1
        return n

    def _account_multi_step(self, decoded_reqs, decode_ctxs, act_n,
                            n: int) -> None:
        """SLO accounting for one n-micro-step dispatch: the window's wall
        time is split evenly across micro-steps and every per-step artifact
        (clock, step_log, phase/width histograms, tracker observations,
        token_times, TTFT/TPOT, finish processing) is emitted per
        micro-step exactly as the single-step path would — only the
        dispatch count changed."""
        dt_total = self.backend.step_time(0, decode_ctxs)
        dt_total += self._step_swap / self.cfg.swap_bw
        dt_each = dt_total / n
        self._last_step_dt = dt_each
        tr = self._tracker()
        cm = getattr(tr, "cost_model", None) if tr is not None else None
        finished_now = []
        for s in range(n):
            act = [r for i, r in enumerate(decoded_reqs) if act_n[i][s]]
            if not act:
                break
            ctx_total = sum(r.prompt_len + r.decoded for r in act)
            self.now += dt_each
            self.step += 1
            self.step_log.append((self.now, 0, len(act), ctx_total))
            self._m_step["decode"].observe(dt_each, t=self.now)
            self._m_prefill_tok.observe(0, t=self.now)
            self._m_decode_seqs.observe(len(act), t=self.now)
            self._m_kv.set(1.0 - self.kv.available_frac, t=self.now)
            if tr is not None:
                pred = cm.predict(0, len(act), float(ctx_total)) \
                    if cm is not None else None
                if pred is not None:
                    self.cost_residuals.append(dt_each - pred)
                    self._m_resid.observe(abs(dt_each - pred), t=self.now)
                tr.on_step(dt_each, 0, len(act), float(ctx_total))
            for r in act:
                r.decoded += 1
                r.token_times.append(self.now)
                if r.first_token_t is None:
                    r.first_token_t = self.now
                    self._m_ttft[r.slo.kind].observe(self.now - r.arrival,
                                                     t=self.now)
                    if self._trace:
                        self.tracer.event("first_token", r.rid, self.now,
                                          self.replica)
                if r.done:
                    r.state = ReqState.FINISHED
                    r.finish_t = self.now
                    if self.cfg.prefix_cache:
                        self._prefix_register(r)
                    self.kv.release(r.rid)
                    self.backend.kv_release(r.rid)
                    self.finished.append(r)
                    finished_now.append(r)
                    self._m_finished.inc(t=self.now)
                    self._tenant_done(r)
                    if r.decoded > 1 and r.first_token_t is not None:
                        self._m_tpot[r.slo.kind].observe(
                            (self.now - r.first_token_t) / (r.decoded - 1),
                            t=self.now)
                    if self._trace:
                        self.tracer.event("finish", r.rid, self.now,
                                          self.replica, decoded=r.decoded)
        for r in finished_now:
            self.sched.on_finish(r, self._view())
            if r.dag_id is not None:
                self._maybe_advance_dag(r)
