"""Every output token that reached the host inside the window, per second
of the window.  In an open loop below capacity this follows the load
offered, and falls only once the server can no longer keep up with it."""

from portbench import slo


def read(run):
    return slo.output_tok_s(run.records, run.start, run.end)
