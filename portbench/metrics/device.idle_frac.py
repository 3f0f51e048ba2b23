"""Share of the profiled stretches in which no operation ran on the card
(the profiler's trace), as a fraction."""


def read(run):
    if run.profile is None or not run.profile["window_s"] \
            or run.device != "cuda":
        return None
    return 1.0 - run.profile["busy_s"] / run.profile["window_s"]
