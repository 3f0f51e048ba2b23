"""Workload synthesis reproducing the paper's evaluation setup (§6.1).

Length statistics follow Table 2 (Chatbot & LC workloads, single and
collective), arrivals are Poisson (or BurstGPT-style bursty: gamma-modulated
rate), request patterns mix 3:1:1 latency:throughput:collective by default,
SLOs follow the paper (TTFT≈2s, TBT≈100ms, TTLT≈20s, collective 20s×stages)
with per-user jitter.  Collective requests instantiate ToT-style trees
(depth 2, 3 thoughts/step) and agentic chains whose stage counts are NOT
revealed to the scheduler (evolving DAGs).

Each request carries ``meta['hint']`` — a noisy function of the true output
length standing in for whatever semantic signal a prompt encoder could
extract.  The noise level is chosen so point prediction stays hard (fig. 2b)
while upper bounds remain learnable (fig. 5b).

Prefix-reuse scenarios (``WorkloadSpec.scenario``, DESIGN.md §6):

  mixed      — the historical default (RNG stream bit-identical to before
               scenarios existed).
  multiturn  — chat sessions whose turn-t prompt extends turn-(t-1)'s
               prompt + reply byte-for-byte (open-loop think-time gaps);
               latency SLOs.
  agentic    — single-chain collective DAGs whose stage-n prompt extends
               stage-(n-1)'s full context (spawned closed-loop at stage
               completion by the engine).

Both carry real token identity: ``meta['prompt_tokens']`` (drawn from a
deterministic per-session/per-chain stream, optionally behind a shared
system prefix) feeds the prefix-cache hash chain AND the jax backend as
actual model input; ``meta['output_tokens']`` is the stream's ground-truth
continuation used to register output pages on simulated backends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import CollectiveDag, Request, SLOSpec

# Table 2: (mean, std, p50, p95) per (workload, single/collective, in/out)
TABLE2 = {
    ("chatbot", "single", "in"): (93, 244, 27, 391),
    ("chatbot", "single", "out"): (318, 313, 225, 1024),
    ("chatbot", "coll", "in"): (1300, 912, 1097, 2767),
    ("chatbot", "coll", "out"): (4458, 1176, 4417, 6452),
    ("lc", "single", "in"): (76, 100, 49, 229),
    ("lc", "single", "out"): (482, 236, 422, 1024),
    ("lc", "coll", "in"): (1064, 389, 983, 1713),
    ("lc", "coll", "out"): (6744, 819, 6703, 8120),
}


def _lognormal_from(mean: float, p50: float, rng: np.random.Generator,
                    n: int = 1) -> np.ndarray:
    """Lognormal matching the (mean, median) pair: mu = ln p50,
    sigma = sqrt(2 ln(mean/p50))."""
    mu = math.log(max(p50, 1.0))
    sigma = math.sqrt(max(2.0 * math.log(max(mean, 1.0) / max(p50, 1.0)),
                          0.05))
    return np.maximum(1, rng.lognormal(mu, sigma, n)).astype(int)


@dataclasses.dataclass
class WorkloadSpec:
    dataset: str = "chatbot"          # chatbot | lc
    rate: float = 2.0                 # requests/s (programs count as one)
    duration: float = 600.0           # s of arrivals
    mix: Tuple[float, float, float] = (3, 1, 1)   # latency:throughput:coll
    best_effort_frac: float = 0.05    # extra non-SLO traffic
    bursty: bool = False              # BurstGPT-style gamma-modulated rate
    ramp_peak: float = 1.0            # peak rate multiplier at mid-duration
    slo_scale: float = 1.0
    slo_jitter: float = 0.3           # per-user SLO heterogeneity
    hint_noise: float = 0.8
    seed: int = 0
    # caps (0 = uncapped): clamp drawn lengths so workloads fit a real
    # backend's device KV pool (PagedJaxBackend.max_len); the RNG draw
    # order is unchanged, only the resulting lengths are clipped.  In the
    # multiturn/agentic scenarios they cap each PER-TURN/PER-STAGE segment
    # (user message, reply, observation) — the accumulated context is
    # their sum, so token streams stay extension-consistent under caps.
    prompt_cap: int = 0
    output_cap: int = 0
    # prefix-reuse scenarios (SCENARIOS registry: mixed | multiturn |
    # agentic | deep_research | any registered plugin)
    scenario: str = "mixed"
    turns: Tuple[int, int] = (2, 6)   # turns per session (uniform, incl.)
    think_time: float = 2.0           # mean extra gap between turns (s)
    system_prompt_len: int = 0        # shared system prefix (tokens)
    shared_system_frac: float = 0.0   # sessions/chains using the prefix
    # arrival process (ARRIVALS registry).  "" = historical auto-dispatch:
    # ramp_peak != 1.0 selects the thinning ramp, else homogeneous Poisson
    # (keeps every pre-existing spec's RNG stream bit-identical).
    arrival: str = ""                 # "" | poisson | ramp_peak | trace
    trace: str = ""                   # rate-profile JSON for arrival="trace"
    # multi-tenant SLO classes: weights over TENANT_CLASSES order
    # (free, pro, enterprise).  Empty = untenanted (no extra RNG draws, so
    # historical streams stay bit-identical).
    tenant_mix: Tuple[float, ...] = ()
    # deep_research scenario shape: stages drawn uniform over
    # research_stages (incl.), middle-stage fan-out uniform 1..breadth
    research_stages: Tuple[int, int] = (4, 8)
    research_breadth: int = 3


# Token values are drawn below the reduced-model vocab (configs/archs.py
# uses 256) so the SAME streams drive the sim hash chain and real jax
# decoding.
TOKEN_VOCAB = 256

# fixed salts (not hash(str): Python's string hash is process-salted and
# would break cross-run determinism) for the per-entity token streams
_STREAM_SALTS = {"sys": 1, "sess": 2, "dag": 3}

# ---------------------------------------------------------------------------
# Multi-tenant SLO classes.  Weight drives admission quota shares and
# weighted-fairness shed order (low weight sheds first); slo_factor scales
# the drawn SLO (enterprise buys tighter targets, free rides looser ones).
# ---------------------------------------------------------------------------
TENANT_CLASSES = ("free", "pro", "enterprise")
TENANT_WEIGHT = {"free": 1.0, "pro": 2.0, "enterprise": 4.0}
TENANT_SLO_FACTOR = {"free": 1.5, "pro": 1.0, "enterprise": 0.8}

# ---------------------------------------------------------------------------
# Scenario / arrival-process registries.  Core validation checks membership
# only, so new workload classes plug in without editing WorkloadGen.  Values
# are callables taking the WorkloadGen and returning an iterable of
# (t, kind, obj) events (scenarios) or a list of arrival times (arrivals).
# ---------------------------------------------------------------------------
SCENARIOS: Dict[str, object] = {}
ARRIVALS: Dict[str, object] = {}


def register_scenario(name: str, fn) -> None:
    SCENARIOS[name] = fn


def register_arrival(name: str, fn) -> None:
    ARRIVALS[name] = fn


def _load_trace(path: str) -> Dict:
    """Committed rate-profile JSON: {"bin_s": s, "rate": [multipliers]}.
    The profile wraps if the workload outlasts it."""
    import json
    with open(path) as f:
        prof = json.load(f)
    rate = np.asarray(prof["rate"], float)
    if rate.size == 0 or rate.max() <= 0:
        raise ValueError(f"trace {path!r}: rate profile empty or all-zero")
    if rate.min() < 0:
        raise ValueError(f"trace {path!r}: negative rate multiplier")
    return {"bin_s": float(prof.get("bin_s", 60.0)), "rate": rate}


class WorkloadGen:
    def __init__(self, spec: WorkloadSpec):
        if spec.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {spec.scenario!r} "
                             f"({' | '.join(sorted(SCENARIOS))})")
        if spec.arrival and spec.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival process {spec.arrival!r} "
                             f"({' | '.join(sorted(ARRIVALS))})")
        if spec.arrival == "trace" and not spec.trace:
            raise ValueError("arrival='trace' needs WorkloadSpec.trace "
                             "(path to a rate-profile JSON)")
        if spec.tenant_mix and len(spec.tenant_mix) > len(TENANT_CLASSES):
            raise ValueError(f"tenant_mix has {len(spec.tenant_mix)} "
                             f"weights for {len(TENANT_CLASSES)} classes")
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self._rid = 0
        self._dag = 0
        self._agentic: Dict[int, Dict] = {}   # dag_id -> chain ground truth
        self._research: Dict[int, Dict] = {}  # dag_id -> tree ground truth
        self._sys: Optional[np.ndarray] = None
        self._trace = _load_trace(spec.trace) \
            if spec.arrival == "trace" else None

    # ------------------------------------------------------------------
    def _lens(self, coll: bool) -> Tuple[int, int]:
        key = (self.spec.dataset, "coll" if coll else "single")
        mi, _, p50i, _ = TABLE2[key + ("in",)] if False else TABLE2[
            (key[0], key[1], "in")]
        mo, _, p50o, _ = TABLE2[(key[0], key[1], "out")]
        li = int(_lognormal_from(mi, p50i, self.rng)[0])
        lo = int(_lognormal_from(mo, p50o, self.rng)[0])
        if self.spec.prompt_cap:
            li = min(li, self.spec.prompt_cap)
        if self.spec.output_cap:
            lo = min(lo, self.spec.output_cap)
        return max(li, 4), max(lo, 8)

    def _hint(self, out_len: int) -> float:
        return float(np.log1p(out_len)
                     + self.rng.normal(0, self.spec.hint_noise))

    def _slo(self, kind: str, stages: int = 1) -> SLOSpec:
        s = self.spec.slo_scale * float(
            np.exp(self.rng.normal(0, self.spec.slo_jitter)))
        if kind == "latency":
            return SLOSpec("latency", ttft=2.0 * s, tbt=0.1 * s,
                           ttlt=1e9)
        if kind == "throughput":
            return SLOSpec("throughput", ttlt=20.0 * s)
        if kind == "collective":
            return SLOSpec("collective", ttlt=20.0 * stages * s)
        return SLOSpec("none", ttlt=1e9)

    def _draw_tenant(self) -> str:
        """Tenant class for the next arrival ("" when untenanted).  Guarded
        on tenant_mix so default specs draw nothing extra from the RNG."""
        sp = self.spec
        if not sp.tenant_mix:
            return ""
        w = np.asarray(sp.tenant_mix, float)
        u = float(self.rng.random()) * float(w.sum())
        i = int(np.searchsorted(np.cumsum(w), u, side="right"))
        return TENANT_CLASSES[min(i, len(sp.tenant_mix) - 1)]

    @staticmethod
    def _label_tenant(r: Request, tenant: str) -> Request:
        """Tenant label + fairness weight only (no SLO rescale — DAG
        deadlines are scaled once at DAG creation)."""
        if tenant:
            r.tenant = tenant
            r.meta["tenant_weight"] = TENANT_WEIGHT[tenant]
        return r

    def _apply_tenant(self, r: Request, tenant: str) -> Request:
        if tenant:
            r.slo = r.slo.scaled(TENANT_SLO_FACTOR[tenant])
        return self._label_tenant(r, tenant)

    # ------------------------------------------------------------------
    def _arrivals(self) -> List[float]:
        """Arrival times via the ARRIVALS registry.  spec.arrival="" keeps
        the historical auto-dispatch (ramp iff ramp_peak != 1.0)."""
        sp = self.spec
        name = sp.arrival or (
            "ramp_peak" if sp.ramp_peak != 1.0 else "poisson")
        return ARRIVALS[name](self)

    def _arrivals_poisson(self) -> List[float]:
        sp = self.spec
        ts, t = [], 0.0
        rate = sp.rate
        while t < sp.duration:
            if sp.bursty and len(ts) % 16 == 0:
                # BurstGPT-ish: re-draw the short-term rate from a Gamma
                # (floored so a lull cannot stall the arrival stream)
                rate = sp.rate * float(self.rng.gamma(0.7, 1.0 / 0.7))
                rate = max(rate, 0.25 * sp.rate)
            t += float(self.rng.exponential(1.0 / rate))
            ts.append(t)
        return ts

    def _arrivals_ramp(self) -> List[float]:
        """Non-homogeneous Poisson by thinning: instantaneous rate ramps
        rate -> rate*ramp_peak at mid-duration and back down (triangular),
        the load profile autoscaling drills exercise.  Separate code path so
        ramp_peak=1.0 workloads keep their exact historical RNG stream.
        ``bursty`` composes: the short-term Gamma rate factor multiplies the
        ramp rate (clamped so thinning stays valid)."""
        sp = self.spec
        burst_cap = 2.5
        rmax = sp.rate * max(1.0, sp.ramp_peak) \
            * (burst_cap if sp.bursty else 1.0)
        ts, t = [], 0.0
        burst, since = 1.0, 16
        while t < sp.duration:
            t += float(self.rng.exponential(1.0 / rmax))
            if sp.bursty and since >= 16:
                burst = float(np.clip(self.rng.gamma(0.7, 1.0 / 0.7),
                                      0.25, burst_cap))
                since = 0
            tri = 1.0 - abs(2.0 * t / sp.duration - 1.0)
            r_t = sp.rate * (1.0 + (sp.ramp_peak - 1.0) * tri) * burst
            if self.rng.random() < r_t / rmax:
                ts.append(t)
                since += 1
        return ts

    def _arrivals_trace(self) -> List[float]:
        """Trace-driven non-homogeneous Poisson by thinning: the committed
        JSON profile gives a piecewise-constant rate multiplier per bin
        (diurnal curves, bursts/spikes); the instantaneous rate is
        spec.rate * multiplier(t mod profile length).  Deterministic given
        (trace, seed) — replaying the same trace reproduces the stream
        byte-for-byte."""
        sp = self.spec
        prof = self._trace
        bins, bin_s = prof["rate"], prof["bin_s"]
        total = bin_s * len(bins)
        rmax = sp.rate * float(bins.max())
        ts, t = [], 0.0
        while t < sp.duration:
            t += float(self.rng.exponential(1.0 / rmax))
            mult = float(bins[int((t % total) // bin_s)])
            if self.rng.random() < mult * sp.rate / rmax:
                ts.append(t)
        return ts

    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    # ------------------------------------------------------------------
    def _mk_single(self, kind: str, t: float, app: str) -> Request:
        li, lo = self._lens(False)
        # in the mixed scenario ``system_prompt_len`` prepends the system
        # prefix to a ``shared_system_frac`` share of singles — the lever
        # for prefill-heavy mixed workloads (disagg benches).  Guarded so
        # the default spec (len 0) draws nothing extra from the RNG and
        # historical streams are bit-identical.
        sp = self.spec
        if sp.system_prompt_len and \
                self.rng.random() < sp.shared_system_frac:
            li += sp.system_prompt_len
        r = Request(rid=self._next_rid(), app=app, arrival=t,
                    prompt_len=li, true_output_len=lo, slo=self._slo(kind))
        r.meta["hint"] = self._hint(lo)
        return self._apply_tenant(r, self._draw_tenant())

    def _mk_dag(self, t: float) -> Tuple[CollectiveDag, List[Request]]:
        """ToT math tree (depth 2, 3 thoughts/step) or agentic chain —
        stage sizes hidden from the scheduler.  ALL per-stage lengths are
        drawn up-front (hidden ground truth) so the total work is identical
        across schedulers regardless of completion order."""
        self._dag += 1
        if self.rng.random() < 0.5:
            app, sizes = "math", [3, 3, 1]          # ToT depth-2
        else:
            app = "agent"
            sizes = [1] * int(self.rng.integers(3, 7))   # codegen chain
        slo = self._slo("collective", stages=len(sizes))
        tenant = self._draw_tenant()
        if tenant:
            slo = slo.scaled(TENANT_SLO_FACTOR[tenant])
        dag = CollectiveDag(dag_id=self._dag, app=app, arrival=t,
                            ttlt=slo.ttlt, stage_sizes=sizes, tenant=tenant)
        stage_lens = []
        for n in sizes:
            lens = []
            for _ in range(n):
                li, lo = self._lens(True)
                lens.append((max(4, li // max(n, 1)),
                             max(8, lo // max(sum(sizes), 1))))
            stage_lens.append(lens)
        self._dag_lens = getattr(self, "_dag_lens", {})
        self._dag_lens[dag.dag_id] = stage_lens
        # rids for EVERY stage are reserved now, at arrival: stage n+1
        # spawns closed-loop at stage-n completion, and completion order
        # is engine- and wall-clock-dependent (real backends measure step
        # time).  Drawing rids at spawn time would bind rid -> logical
        # request differently run to run — and rid seeds the synthesized
        # prompt tokens and hint noise, so token streams would stop being
        # run/tp-invariant (the determinism DESIGN.md §2 promises).
        self._dag_rids = getattr(self, "_dag_rids", {})
        self._dag_rids[dag.dag_id] = [[self._next_rid() for _ in range(n)]
                                      for n in sizes]
        return dag, self.spawn_stage(dag, 0, t)

    def spawn_stage(self, dag: CollectiveDag, stage: int,
                    now: float) -> List[Request]:
        """Stage requests from the precomputed hidden ground truth."""
        if dag.dag_id in self._agentic:
            return self._spawn_agentic_stage(dag, stage, now)
        if dag.dag_id in self._research:
            return self._spawn_research_stage(dag, stage, now)
        reqs = []
        rids = self._dag_rids[dag.dag_id][stage]
        for i, (li, lo) in enumerate(self._dag_lens[dag.dag_id][stage]):
            r = Request(rid=rids[i], app=dag.app, arrival=now,
                        prompt_len=li, true_output_len=lo,
                        slo=SLOSpec("collective",
                                    ttlt=max(dag.deadline - now, 1e-3)),
                        dag_id=dag.dag_id, stage=stage)
            r.meta["hint"] = self._hint_det(lo, r.rid)
            r.meta["n_stages"] = len(dag.stage_sizes)
            reqs.append(self._label_tenant(r, dag.tenant))
        return reqs

    def _hint_det(self, out_len: int, salt: int) -> float:
        """Deterministic hint noise (independent of completion order)."""
        rng = np.random.default_rng((salt * 1000003 + self.spec.seed)
                                    % (2 ** 31))
        return float(np.log1p(out_len)
                     + rng.normal(0, self.spec.hint_noise))

    # ------------------------------------------------------------------
    # Prefix-reuse scenarios: deterministic token streams
    # ------------------------------------------------------------------
    def _stream_tokens(self, kind: str, sid: int, n: int) -> np.ndarray:
        """First n tokens of entity (kind, sid)'s infinite stream.  The
        stream interleaves user/observation and reply segments in arrival
        order, so every prompt is a strict prefix of the stream — turn
        t+1's prompt extends turn t's prompt + reply byte-for-byte."""
        rng = np.random.default_rng(
            (self.spec.seed, _STREAM_SALTS[kind], sid))
        return rng.integers(0, TOKEN_VOCAB, size=n).astype(np.int32)

    def _sys_tokens(self) -> np.ndarray:
        if self._sys is None:
            self._sys = self._stream_tokens(
                "sys", 0, self.spec.system_prompt_len)
        return self._sys

    def _seg_lens(self, coll: bool) -> Tuple[int, int]:
        """One (user/observation, reply) segment draw, capped per-segment
        so accumulated contexts fit a real backend's pool."""
        li, lo = self._lens(coll)
        if self.spec.prompt_cap:
            li = min(li, self.spec.prompt_cap)
        if self.spec.output_cap:
            lo = min(lo, self.spec.output_cap)
        return li, lo

    # -- multiturn: chat sessions accumulating history ------------------
    def _mk_session(self, sid: int, t0: float
                    ) -> List[Tuple[float, str, object]]:
        sp = self.spec
        n_turns = int(self.rng.integers(sp.turns[0], sp.turns[1] + 1))
        shared = bool(self.rng.random() < sp.shared_system_frac)
        sys_len = sp.system_prompt_len if shared else 0
        tenant = self._draw_tenant()   # one class per session
        events, hist, t = [], 0, t0
        for turn in range(n_turns):
            ui, uo = self._seg_lens(False)
            hist += ui
            plen = sys_len + hist
            r = Request(rid=self._next_rid(), app="chatbot", arrival=t,
                        prompt_len=plen, true_output_len=uo,
                        slo=self._slo("latency"), session_id=sid)
            stream = self._stream_tokens("sess", sid, hist + uo)
            ptoks = stream[:hist]
            if sys_len:
                ptoks = np.concatenate([self._sys_tokens(), ptoks])
            r.meta["prompt_tokens"] = ptoks
            r.meta["output_tokens"] = stream[hist:hist + uo]
            r.meta["hint"] = self._hint(uo)
            r.meta["turn"] = turn
            events.append((t, "r", self._apply_tenant(r, tenant)))
            hist += uo
            # open-loop think gap: rough service estimate + think time, so
            # the next turn usually lands after this one finishes (and its
            # pages are registered) — a closed loop would need engine
            # feedback the generator deliberately doesn't have
            t += (0.25 + plen / 2e4 + 0.035 * uo
                  + float(self.rng.exponential(sp.think_time)))
        return events

    def _gen_multiturn(self) -> List[Tuple[float, str, object]]:
        sp = self.spec
        events: List[Tuple[float, str, object]] = []
        t, sid = 0.0, 0
        while True:
            t += float(self.rng.exponential(1.0 / sp.rate))
            if t >= sp.duration:
                break
            sid += 1
            events.extend(self._mk_session(sid, t))
        events.sort(key=lambda e: e[0])   # stable: ties keep stream order
        return events

    # -- agentic: chains whose stage-n prompt extends stage-(n-1) -------
    def _mk_agentic_dag(self, t: float
                        ) -> Tuple[CollectiveDag, List[Request]]:
        """Single-width chain; stage n's prompt = stage n-1's full context
        plus a fresh observation segment.  All segment lengths are drawn
        up-front (hidden ground truth) so total work is scheduler-
        independent; stages spawn closed-loop at stage completion."""
        sp = self.spec
        self._dag += 1
        n_stages = int(self.rng.integers(3, 7))
        shared = bool(self.rng.random() < sp.shared_system_frac)
        slo = self._slo("collective", stages=n_stages)
        tenant = self._draw_tenant()
        if tenant:
            slo = slo.scaled(TENANT_SLO_FACTOR[tenant])
        dag = CollectiveDag(dag_id=self._dag, app="agent", arrival=t,
                            ttlt=slo.ttlt, stage_sizes=[1] * n_stages,
                            tenant=tenant)
        lens = []
        for _ in range(n_stages):
            li, lo = self._seg_lens(True)
            lens.append((max(4, li // 4), max(8, lo // n_stages)))
        # rids reserved at arrival for every stage (see _mk_dag): stages
        # spawn closed-loop, and spawn-time rid draws would make the
        # rid -> request binding completion-order-dependent
        self._agentic[dag.dag_id] = dict(
            lens=lens, sys_len=sp.system_prompt_len if shared else 0,
            rids=[self._next_rid() for _ in range(n_stages)])
        return dag, self.spawn_stage(dag, 0, t)

    def _spawn_agentic_stage(self, dag: CollectiveDag, stage: int,
                             now: float) -> List[Request]:
        info = self._agentic[dag.dag_id]
        lens, sys_len = info["lens"], info["sys_len"]
        hist = sum(li + lo for li, lo in lens[:stage])
        li, lo = lens[stage]
        hist_p = hist + li
        r = Request(rid=info["rids"][stage], app="agent", arrival=now,
                    prompt_len=sys_len + hist_p, true_output_len=lo,
                    slo=SLOSpec("collective",
                                ttlt=max(dag.deadline - now, 1e-3)),
                    dag_id=dag.dag_id, stage=stage)
        stream = self._stream_tokens("dag", dag.dag_id, hist_p + lo)
        ptoks = stream[:hist_p]
        if sys_len:
            ptoks = np.concatenate([self._sys_tokens(), ptoks])
        r.meta["prompt_tokens"] = ptoks
        r.meta["output_tokens"] = stream[hist_p:hist_p + lo]
        r.meta["hint"] = self._hint_det(lo, r.rid)
        r.meta["n_stages"] = len(dag.stage_sizes)
        return [self._label_tenant(r, dag.tenant)]

    def _gen_agentic(self) -> List[Tuple[float, str, object]]:
        sp = self.spec
        events: List[Tuple[float, str, object]] = []
        t = 0.0
        while True:
            t += float(self.rng.exponential(1.0 / sp.rate))
            if t >= sp.duration:
                break
            events.append((t, "dag", self._mk_agentic_dag(t)))
        return events

    # -- deep_research: long compound DAGs with evolving dependencies ---
    def _mk_research_dag(self, t: float
                         ) -> Tuple[CollectiveDag, List[Request]]:
        """Research tree: a plan stage, several fan-out stages of parallel
        searches whose width is drawn per stage (the "evolving" structure —
        neither stage count nor fan-out is revealed to the scheduler), and
        a width-1 synthesis stage.  Every stage-n member's prompt extends
        the FULL accumulated chain context (all prior stages' segments),
        then appends its own fresh query segment — siblings share the
        history prefix (prefix-cache fan-out) and diverge after it.  All
        segment lengths are drawn up-front (hidden ground truth)."""
        sp = self.spec
        self._dag += 1
        n_stages = int(self.rng.integers(sp.research_stages[0],
                                         sp.research_stages[1] + 1))
        sizes = [1] + [int(self.rng.integers(1, sp.research_breadth + 1))
                       for _ in range(max(n_stages - 2, 0))] + [1]
        shared = bool(self.rng.random() < sp.shared_system_frac)
        slo = self._slo("collective", stages=len(sizes))
        tenant = self._draw_tenant()
        if tenant:
            slo = slo.scaled(TENANT_SLO_FACTOR[tenant])
        dag = CollectiveDag(dag_id=self._dag, app="research", arrival=t,
                            ttlt=slo.ttlt, stage_sizes=sizes, tenant=tenant)
        lens = []
        for n in sizes:
            stage = []
            for _ in range(n):
                li, lo = self._seg_lens(True)
                stage.append((max(4, li // 4),
                              max(8, lo // (2 * len(sizes)))))
            lens.append(stage)
        self._research[dag.dag_id] = dict(
            lens=lens, sys_len=sp.system_prompt_len if shared else 0,
            rids=[[self._next_rid() for _ in range(n)] for n in sizes])
        return dag, self.spawn_stage(dag, 0, t)

    def _spawn_research_stage(self, dag: CollectiveDag, stage: int,
                              now: float) -> List[Request]:
        info = self._research[dag.dag_id]
        lens, sys_len = info["lens"], info["sys_len"]
        # accumulated chain context: every prior stage contributed ALL of
        # its members' (query + finding) segments — stage n depends on the
        # union of stage n-1's outputs, not a single parent
        hist = sum(li + lo for st in lens[:stage] for li, lo in st)
        reqs, off = [], 0
        for i, (li, lo) in enumerate(lens[stage]):
            seg0 = hist + off           # this member's slice of the stream
            r = Request(rid=info["rids"][stage][i], app="research",
                        arrival=now, prompt_len=sys_len + hist + li,
                        true_output_len=lo,
                        slo=SLOSpec("collective",
                                    ttlt=max(dag.deadline - now, 1e-3)),
                        dag_id=dag.dag_id, stage=stage)
            stream = self._stream_tokens("dag", dag.dag_id, seg0 + li + lo)
            ptoks = np.concatenate([stream[:hist], stream[seg0:seg0 + li]])
            if sys_len:
                ptoks = np.concatenate([self._sys_tokens(), ptoks])
            r.meta["prompt_tokens"] = ptoks
            r.meta["output_tokens"] = stream[seg0 + li:seg0 + li + lo]
            r.meta["hint"] = self._hint_det(lo, r.rid)
            r.meta["n_stages"] = len(dag.stage_sizes)
            reqs.append(self._label_tenant(r, dag.tenant))
            off += li + lo
        return reqs

    def _gen_deep_research(self) -> List[Tuple[float, str, object]]:
        sp = self.spec
        events: List[Tuple[float, str, object]] = []
        t = 0.0
        while True:
            t += float(self.rng.exponential(1.0 / sp.rate))
            if t >= sp.duration:
                break
            events.append((t, "dag", self._mk_research_dag(t)))
        return events

    # -- mixed: the historical default stream ---------------------------
    def _gen_mixed(self) -> Iterator[Tuple[float, str, object]]:
        sp = self.spec
        mix = np.array(sp.mix, float)
        mix = mix / mix.sum()
        for t in self._arrivals():
            u = self.rng.random()
            if self.rng.random() < sp.best_effort_frac:
                yield t, "r", self._mk_single("none", t, "batch")
            elif u < mix[0]:
                yield t, "r", self._mk_single("latency", t, "chatbot")
            elif u < mix[0] + mix[1]:
                yield t, "r", self._mk_single("throughput", t, "code")
            else:
                yield t, "dag", self._mk_dag(t)

    # ------------------------------------------------------------------
    def arrival_stream(self) -> Iterator[Tuple[float, str, object]]:
        """Time-ordered arrival events, consumable incrementally — a cluster
        router pulls one event at a time and dispatches it to a replica.
        Yields (t, "r", Request) or (t, "dag", (CollectiveDag, stage0 reqs));
        the RNG draw order is identical to ``generate()`` so single-engine
        and cluster runs see the same workload.  Dispatches through the
        SCENARIOS registry."""
        yield from SCENARIOS[self.spec.scenario](self)

    def generate(self):
        """-> (singles: [Request], dags: [(CollectiveDag, stage0 reqs)])."""
        singles: List[Request] = []
        dags: List[Tuple[CollectiveDag, List[Request]]] = []
        for _, kind, obj in self.arrival_stream():
            (singles if kind == "r" else dags).append(obj)
        return singles, dags

    def warmup_requests(self, n: int = 512) -> List[Request]:
        """Completed-looking requests to bootstrap the predictors.  Uses a
        dedicated RNG so warm-starting a predictor NEVER perturbs the actual
        workload stream (schedulers must see identical workloads)."""
        saved, self.rng = self.rng, np.random.default_rng(
            self.spec.seed + 777_777)
        out = []
        try:
            for i in range(n):
                kind = ["latency", "throughput", "collective"][i % 3]
                app = {"latency": "chatbot", "throughput": "code",
                       "collective": "math"}[kind]
                li, lo = self._lens(kind == "collective")
                r = Request(rid=-i - 1, app=app, arrival=0.0, prompt_len=li,
                            true_output_len=lo, slo=self._slo(kind))
                r.meta["hint"] = self._hint(lo)
                out.append(r)
        finally:
            self.rng = saved
        return out


# built-in scenarios / arrival processes (plugins call register_* too)
register_scenario("mixed", WorkloadGen._gen_mixed)
register_scenario("multiturn", WorkloadGen._gen_multiturn)
register_scenario("agentic", WorkloadGen._gen_agentic)
register_scenario("deep_research", WorkloadGen._gen_deep_research)
register_arrival("poisson", WorkloadGen._arrivals_poisson)
register_arrival("ramp_peak", WorkloadGen._arrivals_ramp)
register_arrival("trace", WorkloadGen._arrivals_trace)
