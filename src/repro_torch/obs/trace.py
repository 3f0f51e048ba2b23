"""Per-request lifecycle tracing (DESIGN.md §9).

A :class:`Tracer` collects timestamped span events for each request as it
moves through the engine: ``admit → prefix_match → prefill_chunk* →
(defer/resume | preempt/swap_in)* → first_token → decode → finish|shed``.
Events carry the *simulated* clock, the replica id, and free-form numeric
attributes, and export two ways:

- JSONL (one event per line) — the schema validated by
  ``scripts/validate_obs.py`` and the smoke-obs CI lane;
- Chrome trace-event JSON (``chrome://tracing`` / Perfetto): one process
  per replica, one thread per request, complete ("X") slices computed
  from the span chain at export time, plus instant events for the point
  markers — so a single request's SLO miss is explainable end to end.

Like the metrics registry, the module-level :data:`NULL_TRACER` is the
disabled default: ``event()`` is a no-op, nothing is stored, and tracing
never feeds back into scheduling, so digests are identical on/off.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

# terminal event names: a complete trace ends a request with exactly one
TERMINAL = ("finish", "shed")

# span-opening events and the events that close them (for Chrome "X"
# slices); everything else exports as an instant event
_SPAN_CLOSERS = {
    "admit": ("first_token",) + TERMINAL,      # queue+prefill phase
    "first_token": TERMINAL,                    # decode phase
    "defer": ("resume",) + TERMINAL,
    "preempt": ("swap_in", "resume") + TERMINAL,
    # live KV migration (DESIGN.md §12): handoff_out on the source opens
    # the in-flight span, handoff_in on the destination closes it; the
    # "transfer" instant marks the wire dispatch with bytes/dst attrs
    "handoff_out": ("handoff_in",) + TERMINAL,
}


class Tracer:
    """Bounded event collector.  ``max_events`` caps memory on long runs;
    when full, new events for *new* requests are dropped (existing chains
    keep completing so exported traces stay well-formed)."""

    enabled = True

    def __init__(self, max_events: int = 500_000):
        self.max_events = max_events
        self.events: List[Dict] = []
        self._rids = set()
        self._saturated = False
        self.dropped = 0

    def event(self, name: str, rid: str, t: float, replica: int = 0,
              **attrs) -> None:
        if len(self.events) >= self.max_events:
            if rid not in self._rids:
                self.dropped += 1
                self._saturated = True
                return
        self._rids.add(rid)
        ev = {"name": name, "rid": rid, "t": round(float(t), 9),
              "replica": int(replica)}
        if attrs:
            ev["attrs"] = {k: v for k, v in attrs.items()}
        self.events.append(ev)

    # -- introspection ---------------------------------------------------
    def chain(self, rid: str) -> List[Dict]:
        return [e for e in self.events if e["rid"] == rid]

    def terminal_rids(self) -> set:
        return {e["rid"] for e in self.events if e["name"] in TERMINAL}

    def incomplete_rids(self) -> set:
        """Requests that were admitted but never reached a terminal event
        (still in flight at end of run, or dropped)."""
        admitted = {e["rid"] for e in self.events if e["name"] == "admit"}
        return admitted - self.terminal_rids()

    # -- exports ---------------------------------------------------------
    def to_jsonl(self) -> str:
        return "".join(json.dumps(e, sort_keys=True) + "\n"
                       for e in self.events)

    def to_chrome(self) -> Dict:
        """Chrome trace-event format: pid = replica, tid = request.

        Spans are reconstructed here (not on the hot path): for each
        request, an opening event's slice runs until its first closer.
        """
        by_rid: Dict[str, List[Dict]] = {}
        for e in self.events:
            by_rid.setdefault(e["rid"], []).append(e)

        trace_events: List[Dict] = []
        tids: Dict[str, int] = {}
        pids_named = set()
        for rid in sorted(by_rid):
            evs = sorted(by_rid[rid], key=lambda e: e["t"])
            tid = tids.setdefault(rid, len(tids) + 1)
            pid = evs[0]["replica"]
            if pid not in pids_named:
                pids_named.add(pid)
                trace_events.append({
                    "ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name",
                    "args": {"name": f"replica {pid}"}})
            trace_events.append({
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": rid}})
            for i, e in enumerate(evs):
                us = e["t"] * 1e6
                args = dict(e.get("attrs", {}))
                closers = _SPAN_CLOSERS.get(e["name"])
                if closers:
                    end = next((c for c in evs[i + 1:]
                                if c["name"] in closers), None)
                    dur = max((end["t"] - e["t"]) * 1e6, 0.0) if end else 0.0
                    trace_events.append({
                        "ph": "X", "pid": pid, "tid": tid, "ts": us,
                        "dur": dur, "name": e["name"], "args": args})
                else:
                    trace_events.append({
                        "ph": "i", "pid": pid, "tid": tid, "ts": us,
                        "s": "t", "name": e["name"], "args": args})
        return {"traceEvents": trace_events,
                "displayTimeUnit": "ms"}


class NullTracer:
    """Disabled default — stores nothing, exports empty."""

    enabled = False
    dropped = 0
    __slots__ = ()

    @property
    def events(self) -> List[Dict]:
        return []

    def event(self, name: str, rid: str, t: float, replica: int = 0,
              **attrs) -> None:
        pass

    def chain(self, rid: str) -> List[Dict]:
        return []

    def terminal_rids(self) -> set:
        return set()

    def incomplete_rids(self) -> set:
        return set()

    def to_jsonl(self) -> str:
        return ""

    def to_chrome(self) -> Dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = NullTracer()
