"""90th percentile of the window's streaming requests' TTFT, from each
request's due time, in ms (``slo.ttfts``): the tail the scheduler's
ordering decides; too noisy to bound (§2 of PERF.md)."""

from portbench import slo


def read(run):
    p = slo.pctl(slo.ttfts(run.records, run.start, run.end), 90)
    return None if p is None else p * 1e3
