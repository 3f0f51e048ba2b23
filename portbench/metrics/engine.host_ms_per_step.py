"""Host ms of an engine step outside the backend's calls (the scheduler's
margins, groups and batch, the engine's bookkeeping): ``step_once``'s span
minus its outermost backend calls, the mean over the window's steps."""

from portbench.tracer import window_steps


def read(run):
    if run.tracer is None:
        return None
    steps = window_steps(run)
    if not steps:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] - s["backend_s"]
                     for s in steps) / len(steps)
