"""Model FLOPs of the window's prefill calls (every prompt token they
computed through every matmul, and attention over the tokens before it;
``cost.prefill_flops``) over their spans on the device's stream (CUDA
events) times the H100's bf16 peak, in %."""

from portbench import cost
from portbench.tracer import in_window


def read(run):
    if run.tracer is None or run.device != "cuda":
        return None
    calls = [f for f in run.tracer.prefill_fw if in_window(run, f[5])]
    secs = sum(f[4] for f in calls)
    if not secs:
        return None
    flops = cost.prefill_flops(run.cfg, [f[0] for f in calls])
    return 100.0 * flops / (secs * cost.PEAK_BF16_FLOPS)
