"""Model FLOPs of the window's decode forwards (live lanes only: 2 x the
matmul parameters with the lm_head per token, and attention over each
context; ``cost.decode_flops``) over their spans on the device's stream
(CUDA events) times the H100's bf16 peak, in %."""

from portbench import cost
from portbench.tracer import in_window


def read(run):
    if run.tracer is None or run.device != "cuda":
        return None
    fws = [f for f in run.tracer.decode_fw if in_window(run, f[5]) and f[0]]
    secs = sum(f[4] for f in fws)
    if not secs:
        return None
    flops = sum(cost.decode_flops(run.cfg, f[0]) for f in fws)
    return 100.0 * flops / (secs * cost.PEAK_BF16_FLOPS)
