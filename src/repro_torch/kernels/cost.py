"""What the hand-written kernels report to a cost counter.

``launch.roofline.CostCounter`` counts one run of a function op by op, as
a ``TorchDispatchMode``.  The kernels launch through ``ctypes``, which no
dispatch mode sees, so each kernel wrapper is decorated with ``counted``:
while a counter is active, the wrapper's call is handed to the counter's
``kernel`` method with the wrapper's analytic FLOPs and bytes (the
formulas of the kernels' bounds in ``chip_smoke.py``), and the aten ops it
runs inside (the plain version on the CPU or on ``meta``) are not counted
again.  Without a counter the decorator costs one list test per call.

Each kernel module registers its ``launches`` dict in ``LAUNCHES``, so a
counter can tell a launch that reported its cost from one that did not.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List

# the active counters, innermost last (``launch.roofline.CostCounter``)
ACTIVE: List = []
# every kernel module's launch counts
LAUNCHES: List[Dict[str, int]] = []


def launch_total() -> int:
    """Kernel launches so far, over every registered module."""
    return sum(sum(d.values()) for d in LAUNCHES)


def counted(name: str, cost: Callable):
    """Decorate the wrapper of kernel ``name``: ``cost`` takes the
    wrapper's arguments and returns (flops, bytes) of the call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            return ACTIVE[-1].kernel(
                name, args[0].device,
                lambda: fn(*args, **kwargs),
                lambda: cost(*args, **kwargs))
        return wrapper
    return deco


def collective(kind: str, nbytes: float, group: int, count: int = 1) -> None:
    """Tell the active counter, if any, of ``count`` collectives of ``kind``
    (as ``launch.roofline.wire_bytes`` names them) whose result is
    ``nbytes`` per rank over ``group`` ranks."""
    if ACTIVE:
        ACTIVE[-1].collective(kind, nbytes, group, count)


def lengths_sum(t, capacity: int) -> int:
    """The sum of an int tensor of lengths, read to the host (a counter
    runs outside any timed region); on ``meta``, where nothing can be read,
    ``capacity`` per element."""
    if t.device.type == "meta":
        return capacity * t.numel()
    return int(t.long().sum())
