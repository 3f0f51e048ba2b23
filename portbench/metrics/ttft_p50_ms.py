"""Median TTFT of the window's streaming requests, from each request's
due time to its first token on the host, in ms (``slo.ttfts``): the wait
a streaming user has before the answer starts, its prefill and the step
it runs in included."""

from portbench import slo


def read(run):
    p = slo.pctl(slo.ttfts(run.records, run.start, run.end), 50)
    return None if p is None else p * 1e3
