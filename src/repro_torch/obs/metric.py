"""Live metrics registry: Counter / Gauge / Histogram primitives with label
sets and bounded time-series ring buffers (DESIGN.md §9).

Modeled on ray's ``stats/metric.h`` shape — an instrument is obtained once
from the registry (``registry.counter(name, **labels)``) and then updated on
the hot path with plain method calls; the registry owns one entry per
(name, label-set) pair and renders them to Prometheus text exposition /
JSON snapshots through ``obs/export.py``.

Zero-cost-when-disabled contract: the module-level ``NULL`` registry is the
default everywhere instrumentation is threaded (engine, schedulers,
backends, cluster).  Its instrument getters return one shared no-op
instrument — no dict entry, no ring buffer, no allocation is ever created,
so the disabled hot path pays a single attribute lookup + empty method call
per record site (asserted by tests/test_obs.py).

Determinism contract: instruments never *read* anything — every sample's
timestamp is passed in explicitly by the caller (the engine passes its
simulated clock), and recording has no effect on scheduling state, so
stream digests are byte-identical with telemetry on or off.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# default ring capacity per instrument: bounded so a million-step run keeps
# a fixed memory footprint; the ring holds the TAIL of the series (the
# dashboard's timelines), totals/buckets aggregate the whole run
DEFAULT_RING = 2048

# default histogram bucket upper bounds (seconds-ish scale; callers pass
# their own for token counts etc.)
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
                   10.0)


LabelItems = Tuple[Tuple[str, str], ...]


def _label_items(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Instrument:
    """Common shell: identity (name + labels) and the bounded sample ring.

    ``ring`` holds ``(t, value)`` pairs — for counters the cumulative total
    at ``t``, for gauges the set value, for histograms the raw observation.
    ``t`` is caller-supplied (simulated seconds for engine metrics); when
    omitted a per-instrument sample index is used so series stay ordered.
    """

    kind = "untyped"
    __slots__ = ("name", "labels", "help", "ring", "_n")

    def __init__(self, name: str, labels: LabelItems, help: str = "",
                 ring: int = DEFAULT_RING):
        self.name = name
        self.labels = labels
        self.help = help
        self.ring: deque = deque(maxlen=ring)
        self._n = 0

    def _push(self, t: Optional[float], value: float) -> None:
        if t is None:
            t = float(self._n)
        self._n += 1
        self.ring.append((t, value))

    def series(self) -> List[Tuple[float, float]]:
        return list(self.ring)


class Counter(Instrument):
    kind = "counter"
    __slots__ = ("total",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.total = 0.0

    def inc(self, value: float = 1.0, t: Optional[float] = None) -> None:
        self.total += value
        self._push(t, self.total)


class Gauge(Instrument):
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.value = 0.0

    def set(self, value: float, t: Optional[float] = None) -> None:
        self.value = float(value)
        self._push(t, self.value)


class Histogram(Instrument):
    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, name: str, labels: LabelItems, help: str = "",
                 ring: int = DEFAULT_RING,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, labels, help, ring)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float, t: Optional[float] = None) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self._push(t, v)

    def percentile(self, p: float) -> Optional[float]:
        """Approximate percentile from the bucket CDF (upper-bound linear
        interpolation); None before any observation."""
        if self.count == 0:
            return None
        target = self.count * p / 100.0
        seen = 0
        lo = 0.0 if self.buckets[0] > 0 else self.buckets[0]
        for i, ub in enumerate(self.buckets):
            nxt = seen + self.counts[i]
            if nxt >= target and self.counts[i] > 0:
                frac = (target - seen) / self.counts[i]
                return lo + frac * (ub - lo)
            seen = nxt
            lo = ub
        return self.buckets[-1]


class _NoopInstrument:
    """The shared disabled instrument: every record method is a no-op and
    allocates nothing.  One module-level instance serves every name/label
    combination the NULL registry is asked for."""

    kind = "noop"
    name = ""
    labels: LabelItems = ()
    total = 0.0
    value = 0.0
    count = 0
    sum = 0.0
    __slots__ = ()

    def inc(self, value: float = 1.0, t: Optional[float] = None) -> None:
        pass

    def set(self, value: float, t: Optional[float] = None) -> None:
        pass

    def observe(self, value: float, t: Optional[float] = None) -> None:
        pass

    def series(self) -> List[Tuple[float, float]]:
        return []

    def percentile(self, p: float) -> Optional[float]:
        return None


_NOOP = _NoopInstrument()


class MetricsRegistry:
    """One entry per (name, sorted label items); instruments are created on
    first request and live for the registry's lifetime."""

    enabled = True

    def __init__(self, ring: int = DEFAULT_RING):
        self.ring = ring
        self._metrics: Dict[Tuple[str, LabelItems], Instrument] = {}
        self._help: Dict[str, str] = {}

    # -- instrument getters --------------------------------------------
    def _get(self, cls, name: str, labels: Dict, help: str, **kw):
        key = (name, _label_items(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = cls(name, key[1], help=help or self._help.get(name, ""),
                       ring=self.ring, **kw)
            if help:
                self._help[name] = help
            self._metrics[key] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets)

    def labeled(self, **labels) -> "MetricsRegistry":
        """A view of this registry that stamps ``labels`` onto every
        instrument it hands out — how per-replica identity is attached
        without every call site knowing about replicas."""
        if not labels:
            return self
        return _LabeledView(self, _label_items(labels))

    # -- introspection --------------------------------------------------
    def instruments(self) -> List[Instrument]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def find(self, name: str, **labels) -> List[Instrument]:
        want = set(_label_items(labels))
        return [m for m in self.instruments()
                if m.name == name and want <= set(m.labels)]

    def value_of(self, name: str, **labels) -> Optional[float]:
        """Scalar convenience: counter total / gauge value of the single
        matching instrument (None when absent or ambiguous)."""
        hits = self.find(name, **labels)
        if len(hits) != 1:
            return None
        m = hits[0]
        return m.total if isinstance(m, Counter) else getattr(m, "value",
                                                              None)

    def snapshot(self) -> Dict:
        """JSON-able dump: identity, aggregate state, and the sample ring
        of every instrument (what export/dashboard consume)."""
        out = []
        for m in self.instruments():
            rec = {"name": m.name, "kind": m.kind,
                   "labels": dict(m.labels), "help": m.help,
                   "series": [[round(t, 6), v] for t, v in m.series()]}
            if isinstance(m, Counter):
                rec["total"] = m.total
            elif isinstance(m, Gauge):
                rec["value"] = m.value
            elif isinstance(m, Histogram):
                rec.update(buckets=list(m.buckets), counts=list(m.counts),
                           sum=m.sum, count=m.count)
            out.append(rec)
        return {"metrics": out}


class _LabeledView:
    """Registry facade merging a fixed label set into every getter call.
    Shares the parent's instrument table — snapshot/export happen on the
    root registry."""

    enabled = True
    __slots__ = ("_root", "_labels")

    def __init__(self, root: MetricsRegistry, labels: LabelItems):
        self._root = root
        self._labels = labels

    def _merge(self, labels: Dict) -> Dict:
        out = dict(self._labels)
        out.update({k: str(v) for k, v in labels.items()})
        return out

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._root.counter(name, help, **self._merge(labels))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._root.gauge(name, help, **self._merge(labels))

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._root.histogram(name, help, buckets=buckets,
                                    **self._merge(labels))

    def labeled(self, **labels) -> "MetricsRegistry":
        merged = dict(self._labels)
        merged.update(labels)
        return _LabeledView(self._root, _label_items(merged))

    def snapshot(self) -> Dict:
        return self._root.snapshot()


class NullRegistry:
    """The disabled default: hands out the one shared no-op instrument and
    never creates an entry.  ``enabled`` lets rare, genuinely expensive
    instrumentation (e.g. assembling a big label dict) be skipped wholesale
    with ``if obs.enabled:`` — per-sample record calls don't need the
    guard."""

    enabled = False
    __slots__ = ()

    def counter(self, name: str, help: str = "", **labels):
        return _NOOP

    def gauge(self, name: str, help: str = "", **labels):
        return _NOOP

    def histogram(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
                  **labels):
        return _NOOP

    def labeled(self, **labels) -> "NullRegistry":
        return self

    def instruments(self) -> List[Instrument]:
        return []

    def find(self, name: str, **labels) -> List[Instrument]:
        return []

    def value_of(self, name: str, **labels) -> Optional[float]:
        return None

    def snapshot(self) -> Dict:
        return {"metrics": []}


NULL = NullRegistry()
