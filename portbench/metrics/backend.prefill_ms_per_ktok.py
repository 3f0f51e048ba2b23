"""Ms of prefill per 1000 prompt tokens computed: the spans of the
window's ``Model.prefill_paged`` calls on the device's stream (CUDA
events; on the CPU the host's clock), summed, over the prompt tokens they
computed, whatever the call size."""

from portbench.tracer import in_window


def read(run):
    if run.tracer is None:
        return None
    calls = [f for f in run.tracer.prefill_fw if in_window(run, f[5])]
    tokens = sum(f[0][1] for f in calls)
    if not tokens:
        return None
    return 1e6 * sum(f[4] for f in calls) / tokens
