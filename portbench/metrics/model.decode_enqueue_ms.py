"""Host ms of one decode forward: the mean length of the window's
``model.decode`` spans (``Model.decode_paged``, the program's own span),
the host issuing the eager forward.  On a launch-bound forward the device
runs behind it, so this is the floor of the decode step's wall time."""

from portbench import program_spans

program_spans.install()


def read(run):
    sp = program_spans.spans(run)
    idx = program_spans.window_spans(run, "model.decode")
    if not idx:
        return None
    return sum(sp.t1[i] - sp.t0[i] for i in idx) / len(idx) / 1e6
