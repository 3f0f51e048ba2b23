"""Median of every gap between consecutive tokens of the window's
streaming requests, in ms (``slo.tbts``): the pace a streaming user sees,
one decode step where every live request decodes in every step."""

from portbench import slo


def read(run):
    p = slo.pctl(slo.tbts(run.records, run.start, run.end), 50)
    return None if p is None else p * 1e3
