"""Live lanes over the padded rows a decode call computes, in %: the
``lanes`` and ``rows`` of the window's ``backend.decode`` spans, each
summed (``PagedTorchBackend`` pads a call to a multiple of 64 rows)."""

from portbench import program_spans

program_spans.install()


def read(run):
    idx = program_spans.window_spans(run, "backend.decode")
    if not idx:
        return None
    return 100.0 * program_spans.attr_sum(run, idx, "lanes") \
        / program_spans.attr_sum(run, idx, "rows")
