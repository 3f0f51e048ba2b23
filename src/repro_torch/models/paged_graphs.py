"""CUDA graphs of the paged forwards: decode per padded decode shape,
prefill per chunk shape.

An eager paged forward (``Model._decode_forward``, ``_prefill_forward``)
issues one to two thousand kernels, and the host takes longer to issue
them than the card takes to run them.  ``Model.decode_paged`` and
``prefill_paged`` therefore record their forward once per shape as a CUDA
graph and replay it: the inputs copied in, one graph launch and, for
decode, one copy of the logits, in place of every launch.

A key is the kind of forward and its shape: ("decode", B, n_max, fused)
or ("prefill", C, n_max), so the two kinds never share a graph.  A key's
first call runs eager: that call does the lazy work no graph may hold,
the lm_head's f32 copy, the paged wrapper's ticket counters, the kernel
library's load and the rope table.  Its second call captures the forward
on the inputs copied into the graph's own buffers, then replays it; later
calls replay.  A replay runs the captured kernels, at the captured shapes
and in the captured order, on the same weights, pools and f32 head, with
the caller's inputs copied in first (a host int is filled into its 0-d
buffer: prefill's chunk start and length), so its logits and the pages it
writes are bitwise the eager forward's.

A graph reads every tensor at the address it had at capture, so each must
stay allocated while the graph lives.  A call names its owner: a tuple of
the objects the graphs were captured on, which the model makes of its
``params`` and ``pages`` dicts and its lm_head record (``Model._head_state``:
the head, its version and the f32 copy a decode graph reads).  The table
keeps the owner, and with it everything in it; a call on another owner
(any entry not the same object) drops every graph of either kind, which
frees the old weights they held, and runs eager.  What else a graph reads
stays allocated through the code that makes it: the paged wrapper keeps
every ticket buffer it has handed to a launch, and the rope table is made
once per device (``layers._inv_freq``).  Every graph of a table shares
one memory pool: they run on one stream, never at once.

``usable`` says when a call may take a graph: on CUDA, at tp=1, outside
another capture and outside any ``TorchDispatchMode`` (a cost counter
counts an eager call).  Every other call runs eager.
"""

from __future__ import annotations

from collections import Counter
from numbers import Integral
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import cost
from repro_torch.models.partition import NULL_CTX

KINDS = ("decode", "prefill")       # a key's first entry


def usable(ctx, *inputs) -> bool:
    """Whether a paged call may be captured or replayed: its tensor inputs
    (host ints aside) on CUDA in the serving path's int32, the model at
    tp=1 (``NULL_CTX``: the shared-buffer group's host barrier cannot be
    captured), no stream being captured, and no dispatch mode active."""
    ts = [t for t in inputs if not isinstance(t, Integral)]
    return (ts[0].is_cuda and ctx is NULL_CTX
            and all(t.dtype == torch.int32 for t in ts)
            and not torch.cuda.is_current_stream_capturing()
            and _get_current_dispatch_mode() is None)


def on_device(inputs) -> tuple:
    """``inputs`` with each host int made a 0-d int64 tensor on the first
    tensor's device, filled there: a host-to-device copy would wait on
    it."""
    dev = next(t for t in inputs if isinstance(t, torch.Tensor)).device
    return tuple(t if isinstance(t, torch.Tensor)
                 else torch.full((), t, dtype=torch.int64, device=dev)
                 for t in inputs)


def capture_cuda(graphs: "PagedGraphs", forward: Callable, inputs):
    """Capture ``forward(*inputs)`` as a CUDA graph in the table's memory
    pool.  Returns (graph, its output)."""
    if graphs.pool is None:
        graphs.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=graphs.pool):
        out = forward(*inputs)
    return graph, out


class _Graph:
    __slots__ = ("graph", "inputs", "out", "launches")

    def __init__(self, graph, inputs, out, launches):
        self.graph = graph
        self.inputs = inputs        # its static inputs
        self.out = out              # its static output (decode's logits)
        self.launches = launches    # [(a kernel module's counts, per replay)]


class PagedGraphs:
    """A model's graphs of its paged forwards, of both kinds; see the
    module docstring.  ``capture`` (default ``capture_cuda``) takes
    (table, forward, inputs) and returns (graph, output), the graph having
    a ``replay()``.  ``captures`` and ``replays`` count by kind."""

    def __init__(self, capture: Optional[Callable] = None):
        self._capture = capture or capture_cuda
        self.graphs: Dict[Tuple, _Graph] = {}
        self.seen: set = set()          # keys that ran eager once
        self.owner: Optional[Tuple] = None
        self.pool: Any = None
        self.captures: Counter = Counter()
        self.replays: Counter = Counter()

    def drop(self) -> None:
        """Forget every graph, the keys seen and the owner."""
        self.graphs.clear()
        self.seen.clear()
        self.owner = None
        self.pool = None

    def _owns(self, owner: Tuple) -> bool:
        return self.owner is not None and all(
            a is b for a, b in zip(self.owner, owner))

    def graphed(self, key, owner: Tuple) -> bool:
        """Whether a call of ``key`` on ``owner`` captures or replays."""
        return key in self.seen and self._owns(owner)

    def run(self, key, owner: Tuple, forward: Callable, inputs):
        """``forward(*inputs)`` (the inputs -> its output, or None) for a
        call of ``key`` (kind, shape...) on ``owner``: eager on the key's
        first call, captured then replayed on its second, replayed after.
        Host ints in ``inputs`` reach the forward as 0-d tensors
        (``on_device``).  A call on another owner first drops every graph.
        Returns the forward's output; from a graph, a copy that the next
        replay does not overwrite."""
        if not self._owns(owner):
            self.drop()
            self.owner = owner
        if key in self.graphs:
            return self._replay(key, inputs)
        if key not in self.seen:
            self.seen.add(key)
            return forward(*on_device(inputs))
        # the capture's kernel launches are taken back: the replays count
        static = tuple(t.clone() for t in on_device(inputs))
        before = [dict(d) for d in cost.LAUNCHES]
        graph, out = self._capture(self, forward, static)
        launches: List[Tuple[Dict[str, int], Dict[str, int]]] = []
        for counts, was in zip(cost.LAUNCHES, before):
            per = {k: n - was.get(k, 0) for k, n in counts.items()
                   if n != was.get(k, 0)}
            counts.update(was)
            if per:
                launches.append((counts, per))
        self.graphs[key] = _Graph(graph, static, out, launches)
        self.captures[key[0]] += 1
        return self._replay(key, inputs)

    def _replay(self, key, inputs):
        """Copy ``inputs`` into graph ``key``'s buffers (a host int is
        filled into its 0-d buffer), replay it, count its kernel launches,
        and return a copy of its output, or None."""
        g = self.graphs[key]
        for dst, src in zip(g.inputs, inputs):
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                dst.fill_(src)
        g.graph.replay()
        for counts, per in g.launches:
            for k, n in per.items():
                counts[k] += n
        self.replays[key[0]] += 1
        return None if g.out is None else g.out.clone()
