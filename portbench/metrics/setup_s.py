"""Set-up seconds: from the start of the process to the window's start
(import, kernel build or load, weights, warm-up, the traffic's
pre-roll)."""


def read(run):
    return run.setup_s
