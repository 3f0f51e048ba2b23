"""Every output token that reached the host inside the window, per second
of the window, in a closed loop: the server always holds the same number
of requests, so this is the rate it can serve them at, and it moves with
every step's time (``output_tok_s`` of an open loop follows the load
offered instead)."""

from portbench import slo


def read(run):
    return slo.output_tok_s(run.records, run.start, run.end)
