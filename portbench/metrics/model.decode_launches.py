"""Launches per decode forward: over the measured decode forwards of the
profiled stretch, the mean count of host launch calls made inside each
``rt:model.decode`` range that put work on the device
(``program_spans.decode_forwards``).  A CUDA graph's launch counts once."""

from portbench import program_spans

program_spans.install()


def read(run):
    fw = program_spans.decode_forwards(run)
    if fw is None:
        return None
    return sum(fw["launches"]) / len(fw["launches"])
