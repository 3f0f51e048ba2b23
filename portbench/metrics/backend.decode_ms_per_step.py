"""Wall ms of a decode step in the backend: from the call into
``decode_batch`` to the end of ``step_time``'s synchronisation, the mean
over the window's steps that decode and prefill nothing.  Steps that also
prefill are left out: the backend runs their prefill inside the same
call."""

from portbench.tracer import window_steps


def read(run):
    if run.tracer is None:
        return None
    steps = [s for s in window_steps(run) if not s["prefill"]
             and "decode_t0" in s and "sync_end" in s]
    if not steps:
        return None
    return 1e3 * sum(s["sync_end"] - s["decode_t0"]
                     for s in steps) / len(steps)
