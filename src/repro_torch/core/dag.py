"""Dependency-graph capture & matching for collective requests (paper §4.1).

Super-node representation: every stage of a collective request collapses to
one node whose weight is the stage's aggregate output length; the edge into
it carries the aggregate input length.  A partial execution graph is matched
against per-application history with a weighted Gaussian kernel over node and
edge weight sequences, comparing the shorter graph against the prefix of the
longer one.  The best match's stage-time ratios amortize the end-to-end
deadline over upcoming stages (stage budgeting / straggler hedging).

The `all-node` variant (per-request nodes) is implemented for the fig. 7
accuracy/overhead comparison.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StageRecord:
    n: int                 # requests in stage
    in_len: float          # aggregate input length (edge weight)
    out_len: float         # aggregate output length (node weight)
    duration: float = 0.0  # wall time of the stage


@dataclasses.dataclass
class SuperGraph:
    app: str
    stages: List[StageRecord] = dataclasses.field(default_factory=list)
    # all-node detail (per-request lengths per stage) for the fig.7 variant
    detail: List[List[Tuple[float, float]]] = dataclasses.field(
        default_factory=list)

    @property
    def total_time(self) -> float:
        return sum(s.duration for s in self.stages) or 1e-9

    def stage_ratios(self) -> List[float]:
        t = self.total_time
        return [s.duration / t for s in self.stages]


def _gauss(a: float, b: float, sigma: float) -> float:
    # Gaussian kernel on log-scale weights (lengths span orders of magnitude)
    d = math.log1p(a) - math.log1p(b)
    return math.exp(-(d * d) / (2 * sigma * sigma))


def supernode_similarity(g1: SuperGraph, g2: SuperGraph,
                         sigma: float = 0.6, w_node: float = 0.6) -> float:
    """Prefix similarity: shorter graph vs prefix of longer."""
    k = min(len(g1.stages), len(g2.stages))
    if k == 0:
        return 0.0
    s = 0.0
    for a, b in zip(g1.stages[:k], g2.stages[:k]):
        node = _gauss(a.out_len, b.out_len, sigma) \
            * _gauss(a.n, b.n, sigma)
        edge = _gauss(a.in_len, b.in_len, sigma)
        s += w_node * node + (1 - w_node) * edge
    return s / k


def allnode_similarity(g1: SuperGraph, g2: SuperGraph,
                       sigma: float = 0.6, w_node: float = 0.6) -> float:
    """Per-request-node variant: O(Σ n_i·m_i) pairwise kernel sums."""
    k = min(len(g1.detail), len(g2.detail))
    if k == 0:
        return 0.0
    s = 0.0
    for st1, st2 in zip(g1.detail[:k], g2.detail[:k]):
        if not st1 or not st2:
            continue
        acc = 0.0
        for i1, o1 in st1:
            for i2, o2 in st2:
                acc += w_node * _gauss(o1, o2, sigma) \
                    + (1 - w_node) * _gauss(i1, i2, sigma)
        s += acc / (len(st1) * len(st2))
    return s / k


class DagMatcher:
    """Per-app clustered history + prefix matching + stage budgeting."""

    def __init__(self, max_history_per_app: int = 256,
                 mode: str = "supernode"):
        self.history: Dict[str, List[SuperGraph]] = defaultdict(list)
        self.max_history = max_history_per_app
        self.mode = mode
        self.match_us: List[float] = []     # per-pair matching cost (fig 7)

    def record(self, g: SuperGraph):
        h = self.history[g.app]
        h.append(g)
        if len(h) > self.max_history:
            h.pop(0)

    # ------------------------------------------------------------------
    def match(self, partial: SuperGraph) -> Optional[SuperGraph]:
        """Closest historical graph with MORE stages than the partial one."""
        sim_fn = (supernode_similarity if self.mode == "supernode"
                  else allnode_similarity)
        best, best_s = None, -1.0
        for g in self.history.get(partial.app, []):
            if len(g.stages) <= len(partial.stages):
                continue
            t0 = time.perf_counter()
            s = sim_fn(partial, g)
            self.match_us.append((time.perf_counter() - t0) * 1e6)
            if s > best_s:
                best, best_s = g, s
        return best

    # ------------------------------------------------------------------
    def stage_budget(self, partial: SuperGraph, now: float,
                     deadline: float, elapsed: float) -> Tuple[float, float]:
        """Absolute deadline for the CURRENT stage, plus the estimated
        remaining-stage count.  Distributes the remaining deadline according
        to the matched graph's stage-time ratios; falls back to an even split
        over one extra stage when no history matches."""
        match = self.match(partial)
        cur = len(partial.stages) - 1          # current (running) stage index
        if match is None:
            remaining_stages = 1.0
            frac_cur = 1.0 / 2.0
        else:
            ratios = match.stage_ratios()
            fut = ratios[cur:] if cur < len(ratios) else [1.0]
            tot = sum(fut) or 1.0
            frac_cur = fut[0] / tot
            remaining_stages = float(len(fut))
        budget = max(deadline - now, 1e-3)
        return now + frac_cur * budget, remaining_stages


# ---------------------------------------------------------------------------
# Incremental graph construction (engine-side helper)
# ---------------------------------------------------------------------------
class DagTracker:
    """Builds SuperGraphs as stages of a collective request complete."""

    def __init__(self, matcher: DagMatcher):
        self.matcher = matcher
        self.partials: Dict[int, SuperGraph] = {}
        self.stage_start: Dict[int, float] = {}

    def on_stage_start(self, dag_id: int, app: str, now: float,
                       n: int, in_len: float):
        g = self.partials.setdefault(dag_id, SuperGraph(app=app))
        g.stages.append(StageRecord(n=n, in_len=in_len, out_len=0.0))
        g.detail.append([])
        self.stage_start[dag_id] = now

    def on_request_done(self, dag_id: int, in_len: float, out_len: float):
        g = self.partials.get(dag_id)
        if g and g.stages:
            g.stages[-1].out_len += out_len
            g.detail[-1].append((in_len, out_len))

    def on_stage_end(self, dag_id: int, now: float):
        g = self.partials.get(dag_id)
        if g and g.stages:
            g.stages[-1].duration = now - self.stage_start.get(dag_id, now)

    def on_dag_done(self, dag_id: int, now: float):
        self.on_stage_end(dag_id, now)
        g = self.partials.pop(dag_id, None)
        if g:
            self.matcher.record(g)
