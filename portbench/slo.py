"""SLO judgement and percentiles on the harness's wall clock.

Frozen copies: ``met`` is ``ServiceModel.slo_met``
(``src/repro_torch/core/service.py``) with the request's times read from
the host's stamps instead of the engine's clock, and ``pctl`` is
``serving/metrics.py``'s ``_pctl`` (numpy's linear percentile).  What is
new is the window's rule for requests that are still running when the
window closes: a request whose limit has not passed yet is censored (left
out), one whose limit has passed is a miss.

A record's times are seconds from the traffic's origin: ``due`` when the
request was due (a closed loop's request: when its client took it up;
None until then), ``stamps`` when each of its output tokens reached the
host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

MET, MISS, CENSORED = "met", "miss", "censored"


@dataclasses.dataclass
class Record:
    """One request as the harness saw it."""
    spec: object                       # traffic.Spec
    stamps: List[float] = dataclasses.field(default_factory=list)
    admitted: Optional[float] = None   # when the engine took it in
    shed: bool = False                 # dropped by the scheduler
    due: Optional[float] = None

    def __post_init__(self):
        if self.due is None:
            self.due = self.spec.due

    @property
    def finished(self) -> bool:
        return len(self.stamps) >= self.spec.output_len


def pctl(xs: Sequence[float], p: float) -> Optional[float]:
    """Percentile, or None when there are no samples."""
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, float), p))


def _tbt_index(n_gaps: int, p: float = 0.95) -> int:
    return min(n_gaps - 1, int(p * n_gaps))


def met(r: Record) -> bool:
    """``ServiceModel.slo_met`` of a finished request: best effort is met
    when finished; a latency request needs its TTFT within the limit and
    the 95th percentile of its own gaps (nearest rank below) within the
    TBT limit; a deadline request needs its last token by the deadline."""
    s = r.spec
    if s.kind == "none":
        return True
    if s.kind == "latency":
        if r.stamps[0] - r.due > s.ttft:
            return False
        gaps = sorted(np.diff(r.stamps))
        if not gaps:
            return True
        return gaps[_tbt_index(len(gaps))] <= s.tbt
    return r.stamps[-1] - r.due <= s.ttlt


def judge(r: Record, close: float) -> str:
    """MET, MISS or CENSORED at the window's close."""
    s = r.spec
    if r.shed:
        return MISS
    if r.finished:
        return MET if met(r) else MISS
    waited = close - r.due
    if s.kind == "none":
        return CENSORED
    if s.kind == "throughput":
        return MISS if waited > s.ttlt else CENSORED
    if not r.stamps:
        return MISS if waited > s.ttft else CENSORED
    if r.stamps[0] - r.due > s.ttft:
        return MISS
    # the final gap count is known: a miss once more gaps are over the
    # limit than the 95th percentile's rank allows
    n = s.output_len - 1
    over = int(np.sum(np.diff(r.stamps) > s.tbt))
    return MISS if over >= n - _tbt_index(n) else CENSORED


def window(records: List[Record], start: float, end: float) -> List[Record]:
    """The requests due inside the window."""
    return [r for r in records if r.due is not None and start < r.due < end]


def goodput_tok_s(records: List[Record], start: float, end: float) -> float:
    """Output tokens of the window's requests that met their SLO, per
    second of the window."""
    tok = sum(r.spec.output_len for r in window(records, start, end)
              if judge(r, end) == MET)
    return tok / (end - start)


def output_tok_s(records: List[Record], start: float, end: float) -> float:
    """Every output token that reached the host inside the window, per
    second of the window."""
    n = sum(int(np.sum((np.asarray(r.stamps) > start)
                       & (np.asarray(r.stamps) <= end)))
            for r in records if r.stamps)
    return n / (end - start)


def ttfts(records: List[Record], start: float, end: float) -> List[float]:
    """TTFT (s) of the window's streaming requests: from due to the first
    token; a request with no first token past its limit counts with the
    time it has waited at the close (a lower bound: it is a miss either
    way), and one still within its limit is left out."""
    out = []
    for r in window(records, start, end):
        if r.spec.kind != "latency":
            continue
        if r.stamps:
            out.append(r.stamps[0] - r.due)
        elif r.shed or end - r.due > r.spec.ttft:
            out.append(end - r.due)
    return out


def tbts(records: List[Record], start: float, end: float) -> List[float]:
    """Every gap (s) between consecutive tokens of the window's streaming
    requests."""
    out: List[float] = []
    for r in window(records, start, end):
        if r.spec.kind == "latency" and len(r.stamps) > 1:
            out.extend(np.diff(r.stamps).tolist())
    return out


def attainment(records: List[Record], start: float, end: float,
               close: Optional[float] = None):
    """(met, judged, censored) over the window's requests, judged at
    ``close`` (default: the window's end)."""
    close = end if close is None else close
    verdicts = [judge(r, close) for r in window(records, start, end)]
    return (verdicts.count(MET), len(verdicts) - verdicts.count(CENSORED),
            verdicts.count(CENSORED))
