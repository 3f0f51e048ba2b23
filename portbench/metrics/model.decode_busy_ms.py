"""Device ms of one decode forward: over the measured decode forwards of
the profiled stretch, the mean union of the device intervals of the
operations launched from inside each ``rt:model.decode`` range (the
program's span on the profiler's clock; ``program_spans.decode_forwards``).
Beside ``model.decode_enqueue_ms`` it says how far the host's issue of
the forward, and not the device's work, sets the decode step."""

from portbench import program_spans

program_spans.install()


def read(run):
    fw = program_spans.decode_forwards(run)
    if fw is None:
        return None
    return 1e3 * sum(fw["busy_s"]) / len(fw["busy_s"])
