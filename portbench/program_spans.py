"""The program's own spans (``repro_torch/obs/spans.py``) in the traced
run, and what the metrics that read them share.

The readers of those metrics call ``install()`` when they are loaded:
``run.py`` loads a cell's per-layer readers before it sets the run up,
and only in a traced run (``Bench.metrics``), so untraced runs, and the
traced runs of cells that list none of these readers, run the harness as
it is.  ``install()`` changes three things in the process, once:

- each ``tracer.Tracer`` attaches a ``Spans`` to the backend, where the
  program has ``attach_spans`` (a program without it records nothing, and
  the readers return None), and keeps it as ``spans``;
- ``tracer._host_spans`` also returns the program's ``rt:`` ranges, named
  without the prefix, so an idle gap on the device is named by the
  innermost span, the program's or the harness's.  No program span is
  named ``engine``, the harness's step;
- ``tracer._device_events`` drops the ``rt:`` ranges that the profiler
  also lays on the device's timeline, as it drops the ``pb:`` ones, so
  ``busy_s``, ``window_s`` and every device metric read as before.

The three belong in ``tracer.py`` itself (``Tracer.__init__``,
``_host_spans``, ``_device_events``); until they move there, only the
cells that list these readers run with them.

``decode_forwards`` reads the profiled stretch per decode forward: a
device operation belongs to the ``rt:model.decode`` range in which the
host call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel*``,
``cudaMemcpyAsync``, ``cudaGraphLaunch``, ...) began, matched by the
profiler's correlation id.  An operation whose launch call is missing
from the trace falls back to the start of the host op it is linked to,
else to its own start; ``fallbacks`` counts them.  Two cross-checks hold
every reading: each forward launched one ``paged_kernel`` per layer, and
the forwards' device time summed is within the stretch's ``busy_s``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from portbench import tracer as tracer_mod

PREFIX = "rt:"          # the profiler's name of a program span


def install() -> None:
    """Patch ``portbench.tracer`` as the module docstring says; again a
    no-op."""
    if getattr(tracer_mod, "_program_spans", False):
        return
    init = tracer_mod.Tracer.__init__

    def __init__(self, served, *a, **k):
        init(self, served, *a, **k)
        self.spans = None
        if hasattr(self.be, "attach_spans"):
            from repro_torch.obs.spans import Spans

            self.spans = Spans()
            self.be.attach_spans(self.spans)

    tracer_mod.Tracer.__init__ = __init__
    tracer_mod._host_spans = host_spans
    tracer_mod._device_events = device_events
    tracer_mod._program_spans = True


def host_spans(prof) -> List:
    """(start, end, span) of the ``pb:`` and ``rt:`` ranges on the host,
    in seconds, the prefix taken off."""
    from torch.autograd import DeviceType

    return [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name[3:])
            for e in prof.events()
            if e.name.startswith(("pb:", PREFIX))
            and e.device_type != DeviceType.CUDA]


def device_events(prof) -> List:
    """(start, end, name) of the operations on the device, in seconds,
    without the ranges of either prefix."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("pb:", PREFIX)))


# -- the readers' shared parts ------------------------------------------
def spans(run):
    """The run's program spans, or None (untraced, or a program without
    them)."""
    return getattr(run.tracer, "spans", None)


def window_spans(run, name: str) -> List[int]:
    """Indices of the closed spans called ``name`` that began inside the
    window."""
    sp = spans(run)
    if sp is None:
        return []
    lo = (run.origin + run.start) * 1e9
    hi = (run.origin + run.end) * 1e9
    return [i for i in sp.select(name) if lo <= sp.t0[i] < hi]


def attr_sum(run, idx: List[int], key: str) -> int:
    sp = spans(run)
    return sum(sp.attrs[i][key] for i in idx)


def decode_forwards(run) -> Optional[Dict]:
    """The measured decode forwards of the profiled stretch (those that
    began inside its measured steps, as ``Tracer._profile`` takes them):
    ``launches``, ``busy_s`` (the union of the device intervals of the
    operations launched inside each forward) and ``paged`` (its
    ``paged_kernel`` launches), a list each; ``fallbacks``, the device
    operations placed without their launch call.  None off the card, or
    when the program recorded no ``rt:model.decode`` range."""
    tr = run.tracer
    if tr is None or run.device != "cuda" or spans(run) is None \
            or getattr(tr, "_prof", None) is None:
        return None
    cached = getattr(tr, "_decode_forwards", None)
    if cached is None:
        cached = tr._decode_forwards = _decode_forwards(tr._prof.events())
        layers = run.cfg["num_hidden_layers"]
        if any(p != layers for p in cached["paged"]):
            raise RuntimeError(
                f"paged_kernel launches per decode forward "
                f"{cached['paged']}, not one per layer ({layers})")
        if sum(cached["busy_s"]) > run.profile["busy_s"] + 1e-9:
            raise RuntimeError(
                f"decode forwards busy {sum(cached['busy_s'])} s, above "
                f"the profiled stretch's {run.profile['busy_s']} s")
    return cached if cached["launches"] else None


def _decode_forwards(events) -> Dict:
    from torch.autograd import DeviceType

    out = dict(launches=[], busy_s=[], paged=[], fallbacks=0)
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "pb:engine"
                   and e.device_type != DeviceType.CUDA)
    if len(steps) < 2:
        return out
    w0, w1 = steps[1][0], steps[-1][1]
    fws = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.name == PREFIX + "model.decode"
                 and e.device_type != DeviceType.CUDA
                 and w0 <= e.time_range.start <= w1)
    if not fws:
        return out
    starts = [f[0] for f in fws]
    launch: Dict[int, float] = {}     # correlation id -> launch call start
    ops: Dict[int, float] = {}        # host op id -> its start
    dev = []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(("pb:", PREFIX)):
                dev.append(e)
        elif e.name.startswith("cu"):
            launch[e.id] = e.time_range.start
        else:
            ops[e.id] = e.time_range.start
    per = [dict(calls=set(), spans=[], paged=0) for _ in fws]
    for e in dev:
        key, t = e.id, launch.get(e.id)
        if t is None:
            out["fallbacks"] += 1
            link = getattr(e, "linked_correlation_id", 0)
            t = ops.get(link, e.time_range.start)
            key = ("op", link) if link in ops else ("dev", e.id)
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t > fws[k][1]:
            continue
        f = per[k]
        f["calls"].add(key)
        f["spans"].append((e.time_range.start, e.time_range.end))
        f["paged"] += "paged_kernel" in e.name
    for f in per:
        busy, end = 0.0, None
        for a, b in sorted(f["spans"]):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        out["launches"].append(len(f["calls"]))
        out["busy_s"].append(busy / 1e6)
        out["paged"].append(f["paged"])
    return out
