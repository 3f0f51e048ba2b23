"""95th percentile of every gap between consecutive tokens of the window's
streaming requests, in ms (``slo.tbts``): the gaps that steps carrying a
prefill stretch; too noisy to bound (§2 of PERF.md)."""

from portbench import slo


def read(run):
    p = slo.pctl(slo.tbts(run.records, run.start, run.end), 95)
    return None if p is None else p * 1e3
