"""The traced run's instrumentation, all from outside the program.

- Spans on the host's clock around the calls into each layer: the
  engine's ``step_once``, and the backend's methods that the engine calls
  (wrapped on the instance, so the program is not edited).  A step's
  engine time is its span minus its outermost backend calls.
- CUDA events around every ``Model.prefill_paged`` / ``decode_paged``
  call: the call's span on the device's stream.
- ``torch.profiler``, only once the window has closed: the run serves on
  into the traffic's next arrivals for one profiled stretch of ``steps``
  steps, so nothing the profiler costs (loading its libraries, the host
  ops it records, the collection of its events) falls inside the window.
  The stretch records the host's ops beside the device's, which slows the
  host (with the device alone, whole stretches lost their kernels): its
  busy seconds are the device's work, its idle share that of a profiled
  step, above an unprofiled one's.  Every span is also a
  ``record_function`` range named ``pb:<span>``, so an idle gap on the
  device is named by the innermost host span it fell in.  The first step
  of the stretch is the profiler's warm-up and is left out.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

BACKEND_SPANS = ("begin_step", "prefill_chunk", "decode_batch",
                 "decode_batch_n", "step_time", "kv_swap_out", "kv_swap_in",
                 "kv_copy_page", "kv_release", "output_tokens")
# spans inside the backend's calls, named for the breakdown
INNER_SPANS = {"_flush_prefill": "backend.prefill",
               "_stage_decode": "backend.staging"}


class Tracer:
    def __init__(self, served, start: float, end: float, steps: int = 8):
        self.be = served.backend
        self.cuda = served.device.type == "cuda"
        self.end = end
        self.steps: List[Dict] = []
        # per forward: [ctxs | (start, n), ev0, ev1, measured, seconds,
        # host start]
        self.decode_fw: List[list] = []
        self.prefill_fw: List[list] = []
        self._ctxs: List[List[int]] = []
        self._cur = None
        self._depth = 0
        self.profiling = False          # inside the profiled stretch
        self.measuring = False          # a measured step of it
        self._steps = steps
        self._left = steps + 1          # profiled steps to come, warm-up in
        self._prof = None
        self._wrap()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def wants_steps(self) -> bool:
        """Whether the run should serve on past the window's end."""
        return self._left > 0

    # -- wrapping --------------------------------------------------------
    def label(self, name: str):
        if self.profiling:
            return torch.profiler.record_function(f"pb:{name}")
        return contextlib.nullcontext()

    def _wrap(self) -> None:
        be = self.be
        for name in BACKEND_SPANS:
            setattr(be, name, self._backend(name, getattr(be, name)))
        for name, label in INNER_SPANS.items():
            setattr(be, name, self._inner(label, getattr(be, name)))
        be.sampler.sample_device = self._inner("sampler",
                                               be.sampler.sample_device)
        model = be.model
        model.decode_paged = self._forward("model.decode",
                                           model.decode_paged)
        model.prefill_paged = self._forward("model.prefill",
                                            model.prefill_paged)

    def _inner(self, label, fn):
        def wrapper(*a, **k):
            with self.label(label):
                return fn(*a, **k)
        return wrapper

    def _backend(self, name, fn):
        def wrapper(*a, **k):
            top = self._depth == 0
            self._depth += 1
            t0 = time.perf_counter()
            cur = self._cur
            if name == "decode_batch_n" and a[0]:
                n = a[2]
                self._ctxs.extend([[r.prompt_len - 1 + r.decoded + s
                                    for r in a[0]
                                    if r.true_output_len - r.decoded > s]
                                   for s in range(n)])
            if cur is not None and top:
                if name in ("decode_batch", "decode_batch_n") and a[0]:
                    cur["decode_t0"] = t0
                if name == "prefill_chunk":
                    cur["prefill"] = True
            try:
                with self.label(f"backend.{name}"):
                    return fn(*a, **k)
            finally:
                self._depth -= 1
                t1 = time.perf_counter()
                if cur is not None and top:
                    cur["backend_s"] += t1 - t0
                    if name == "step_time":
                        cur["sync_end"] = t1
        return wrapper

    def _forward(self, label, fn):
        def wrapper(*a, **k):
            if label == "model.decode":
                info = self._ctxs.pop(0) if self._ctxs else []
            else:       # prefill_paged(params, pages, tokens, start, tab, n)
                info = (int(a[3]), int(a[5]))
            ev0 = ev1 = None
            t0 = time.perf_counter()
            if self.cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            with self.label(label):
                out = fn(*a, **k)
            if self.cuda:
                ev1.record()
            rec = [info, ev0, ev1, self.measuring,
                   time.perf_counter() - t0, t0]
            (self.decode_fw if label == "model.decode"
             else self.prefill_fw).append(rec)
            return out
        return wrapper

    # -- steps and the profiler -----------------------------------------
    def step(self, fn, now: float) -> None:
        if not self.profiling and self._left > 0 and now >= self.end:
            self._prof = torch.profiler.profile(
                activities=self._activities())
            self._prof.start()
            self.profiling = True
        # the first step of the stretch is the profiler's warm-up
        self.measuring = self.profiling and self._left <= self._steps
        cur = dict(t0=time.perf_counter(), backend_s=0.0, prefill=False)
        self._cur = cur
        with self.label("engine"):
            fn()
        cur["t1"] = time.perf_counter()
        self._cur = None
        self.steps.append(cur)
        self.measuring = False
        if self.profiling:
            self._left -= 1
            if self._left == 0:
                self._prof.stop()
                self.profiling = False

    def finish(self) -> Dict:
        """Read every event and the profiled stretch; call once the run
        has served its last step."""
        if self.profiling:
            self._prof.stop()
            self.profiling = False
        if self.cuda:
            torch.cuda.synchronize()
        for rec in self.decode_fw + self.prefill_fw:
            if rec[1] is not None:
                rec[4] = rec[1].elapsed_time(rec[2]) / 1e3
        return self._profile()

    def _profile(self) -> Dict:
        """busy_s, window_s, kernel seconds by name, the paged decode
        kernel's seconds, and idle seconds by the host span they fell in,
        over the measured steps of the profiled stretch."""
        out = dict(busy_s=0.0, window_s=0.0, ops=defaultdict(float),
                   paged_s=0.0, idle=defaultdict(float), steps=0)
        if self._prof is None or not self.cuda:
            return out
        dev, host = _device_events(self._prof), _host_spans(self._prof)
        steps = sorted(h for h in host if h[2] == "engine")
        if len(steps) < 2:
            return out
        w0, w1 = steps[1][0], steps[-1][1]
        out["window_s"], out["steps"] = w1 - w0, len(steps) - 1
        spans = _clip(dev, w0, w1, out)
        out["busy_s"] = sum(b - a for a, b in spans)
        edges = [w0] + [x for s in spans for x in s] + [w1]
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            inside = [h for h in host if h[0] <= mid <= h[1]]
            name = max(inside)[2] if inside else "harness"
            out["idle"][name] += g1 - g0
        return out


def in_window(run, t: float) -> bool:
    """Whether ``t``, a ``time.perf_counter`` reading, fell inside the
    run's window."""
    return run.origin + run.start <= t < run.origin + run.end


def window_steps(run) -> List[Dict]:
    """The traced run's engine steps that began inside the window."""
    return [s for s in run.tracer.steps if in_window(run, s["t0"])]


def _device_events(prof) -> List:
    """(start, end, name) of the operations on the device, in seconds."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("pb:"))


def _host_spans(prof) -> List:
    """(start, end, span) of the ``pb:`` ranges on the host."""
    from torch.autograd import DeviceType

    return [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name[3:])
            for e in prof.events()
            if e.name.startswith("pb:") and e.device_type != DeviceType.CUDA]


def _clip(dev, w0: float, w1: float, out) -> List[List[float]]:
    """The union of the operations' times inside [w0, w1]; each
    operation's seconds added to ``out``'s ``ops`` and ``paged_s``."""
    spans: List[List[float]] = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        out["ops"][name[:100]] += b - a
        if "paged_kernel" in name:
            out["paged_s"] += b - a
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return spans
