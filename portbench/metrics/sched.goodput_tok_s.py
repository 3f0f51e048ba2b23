"""Output tokens of the window's requests that met their SLO, per second
of the window (``slo.goodput_tok_s``): the paper's goodput.  A per-layer
metric of the scheduler, which decides which requests make their limits;
too noisy to bound (§2 of PERF.md)."""

from portbench import slo


def read(run):
    return slo.goodput_tok_s(run.records, run.start, run.end)
