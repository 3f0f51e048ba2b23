"""``fused_decode_attention``'s share of its roofline, in %: the bytes
its launches in the profiled stretches must move (each live lane's K/V
context, query, output and new K/V row once, every layer;
``cost.decode_attention_bytes``) over HBM bandwidth, against their device
time (``paged_kernel`` in the profiler's trace).  Memory bounds the
kernel: its FLOPs per byte are far below the card's ridge."""

from portbench import cost


def read(run):
    if run.profile is None or not run.profile["paged_s"]:
        return None
    fws = [f for f in run.tracer.decode_fw if f[3] and f[0]]
    layers = run.cfg["num_hidden_layers"]
    nbytes = sum(layers * cost.decode_attention_bytes(run.cfg, f[0])
                 for f in fws)
    return 100.0 * nbytes / cost.HBM_BYTES_S / run.profile["paged_s"]
