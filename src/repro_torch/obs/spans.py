"""Wall-clock spans of the port's backend and paged model step.

:class:`Spans` keeps, in memory, one record per span: its name, its start
and end on ``time.perf_counter_ns()``, the index of the span that encloses
it (-1 at the top) and small integer attributes (``rows``, ``lanes``,
``tokens``).  No span belongs to one request: a request's own times are
the engine's lifecycle tracer's (``obs/trace.py``).  Storage is
bounded: once ``capacity`` spans are stored, new ones are dropped and
counted in ``dropped``, as :class:`~repro_torch.obs.trace.Tracer` drops
events.  Nothing is written to disk.

While a torch profiler is running (the profiler's own test,
``torch.autograd._profiler_enabled()``), each span also opens
``torch.profiler.record_function("rt:<name>")``, so the profiler records
the same range on its own clock, beside the kernels launched inside it.

:data:`NULL_SPANS` is the disabled default.  A call site is one line::

    with self.spans.span("backend.decode", rows=B, lanes=n):
        ...

Off, ``span`` returns one shared no-op context, so a span costs a call
and that context's enter and exit, and touches no clock.  On, the span is
closed however its body ends, an exception included.

Spans nest by call order on one thread.  Under serving TP only rank 0
records (the workers keep :data:`NULL_SPANS`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

PREFIX = "rt:"      # the profiler's name of a span: PREFIX + name


class Spans:
    """Bounded in-memory span recorder; see the module docstring."""

    on = True

    def __init__(self, capacity: int = 500_000):
        self.capacity = capacity
        self.name: List[str] = []
        self.t0: List[int] = []
        self.t1: List[int] = []
        self.parent: List[int] = []
        self.attrs: List[Optional[Dict[str, int]]] = []
        self.dropped = 0
        self._open: List[int] = []      # indices of the open spans
        self._rf: List[object] = []     # their record_function, or None

    def __len__(self) -> int:
        return len(self.name)

    def begin(self, name: str, **attrs: int) -> int:
        """Open a span; returns its index (-1 when dropped)."""
        i = len(self.name)
        if i >= self.capacity:
            self.dropped += 1
            return -1
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
        self.name.append(name)
        self.parent.append(self._open[-1] if self._open else -1)
        self.attrs.append(attrs or None)
        self.t1.append(0)
        self._open.append(i)
        self._rf.append(rf)
        self.t0.append(time.perf_counter_ns())
        return i

    def end(self, i: int) -> None:
        """Close span ``i``, and any span left open inside it (those keep
        an end of 0, and ``select`` skips them); -1 is a no-op."""
        if i < 0:
            return
        self.t1[i] = time.perf_counter_ns()
        while self._open:
            j = self._open.pop()
            rf = self._rf.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            if j == i:
                break

    @contextlib.contextmanager
    def span(self, name: str, **attrs: int):
        """``begin`` and ``end`` around the body of a ``with``."""
        i = self.begin(name, **attrs)
        try:
            yield
        finally:
            self.end(i)

    def select(self, name: str) -> List[int]:
        """Indices of the closed spans called ``name``, in start order."""
        return [i for i, n in enumerate(self.name)
                if n == name and self.t1[i]]


_NO_SPAN = contextlib.nullcontext()


class NullSpans:
    """Disabled default: ``on`` is False, and ``span`` returns one shared
    no-op context."""

    on = False
    __slots__ = ()

    def span(self, name: str, **attrs: int):
        return _NO_SPAN

    def begin(self, name: str, **attrs: int) -> int:
        return -1

    def end(self, i: int) -> None:
        pass


NULL_SPANS = NullSpans()
