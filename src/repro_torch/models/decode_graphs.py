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

A graph reads every tensor at the address it had at capture.  So each
graph holds what it reads that no caller owns (the f32 head, the ticket
counters, the rope table), and the table holds the ``params`` and
``pages`` dicts it was captured on.  It stays valid while a call passes
those same dicts and an unchanged lm_head (the same tensor, the same
version); on any other call every graph of either kind is dropped, which
frees the old weights they held, and the call runs eager.  Every graph of
a table shares one memory pool: they run on one stream, never at once.

``usable`` says when a call may take a graph: on CUDA, at tp=1, outside
another capture and outside any ``TorchDispatchMode`` (a cost counter
counts an eager call).  Every other call runs eager.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import cost
from repro_torch.models.partition import NULL_CTX

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
KINDS = ("decode", "prefill")       # a key's first entry


def usable(ctx, *inputs) -> bool:
    """Whether a paged call may be captured or replayed: CUDA tensor
    inputs of the serving path's int32, the model at tp=1 (``NULL_CTX``:
    the shared-buffer group's host barrier cannot be captured), no stream
    being captured, and no dispatch mode active."""
    return (inputs[0].is_cuda and ctx is NULL_CTX
            and all(t.dtype == torch.int32 for t in inputs)
            and not torch.cuda.is_current_stream_capturing()
            and _get_current_dispatch_mode() is None)


def capture_cuda(graphs: "DecodeGraphs", forward: Callable, inputs):
    """Capture ``forward(*inputs)`` as a CUDA graph in the table's memory
    pool.  Returns (graph, its output)."""
    if graphs.pool is None:
        graphs.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=graphs.pool):
        out = forward(*inputs)
    return graph, out


class _Graph:
    __slots__ = ("graph", "inputs", "out", "launches", "holds")

    def __init__(self, graph, inputs, out, launches, holds):
        self.graph = graph
        self.inputs = inputs        # its static inputs
        self.out = out              # its static output (decode's logits)
        self.launches = launches    # [(a kernel module's counts, per replay)]
        self.holds = holds          # tensors it reads that no caller owns


class DecodeGraphs:
    """A model's graphs of its paged forwards, of both kinds; see the
    module docstring.  ``capture`` (default ``capture_cuda``) takes
    (table, forward, inputs) and returns (graph, output), the graph having
    a ``replay()``.  ``captures`` and ``replays`` count by kind."""

    def __init__(self, capture: Optional[Callable] = None):
        self._capture = capture or capture_cuda
        self.graphs: Dict[Tuple, _Graph] = {}
        self.seen: set = set()          # keys that ran eager once
        self.owner: Optional[Tuple] = None   # (params, pages, head, version)
        self.pool: Any = None
        self.captures: Counter = Counter()
        self.replays: Counter = Counter()

    def drop(self) -> None:
        """Forget every graph, the keys seen and the dicts they held."""
        self.graphs.clear()
        self.seen.clear()
        self.owner = None
        self.pool = None

    def plan(self, key, params, pages, head) -> str:
        """EAGER, CAPTURE or REPLAY for a call of ``key`` (kind, shape...)
        on these ``params`` and ``pages`` dicts and lm_head ``head``; a
        call on others first drops every graph."""
        own = self.owner
        if (own is None or own[0] is not params or own[1] is not pages
                or own[2] is not head or own[3] != head._version):
            self.drop()
            self.owner = (params, pages, head, head._version)
        if key in self.graphs:
            return REPLAY
        if key in self.seen:
            return CAPTURE
        self.seen.add(key)
        return EAGER

    def capture(self, key, forward: Callable, inputs, holds):
        """Capture ``forward`` (the inputs -> its output, or None) on
        copies of the tensors ``inputs`` and keep it under ``key`` with
        ``holds``; then replay it for this call.  The kernel launches the
        capture counted are taken back: the replays count them."""
        static = tuple(t.clone() for t in inputs)
        before = [dict(d) for d in cost.LAUNCHES]
        graph, out = self._capture(self, forward, static)
        launches: List[Tuple[Dict[str, int], Dict[str, int]]] = []
        for counts, was in zip(cost.LAUNCHES, before):
            per = {k: n - was.get(k, 0) for k, n in counts.items()
                   if n != was.get(k, 0)}
            counts.update(was)
            if per:
                launches.append((counts, per))
        self.graphs[key] = _Graph(graph, static, out, launches, holds)
        self.captures[key[0]] += 1
        return self.replay(key, inputs)

    def replay(self, key, inputs):
        """Copy ``inputs`` into graph ``key``'s buffers (a host int is
        filled into its 0-d buffer), replay it, count its kernel launches,
        and return a copy of its output (the next replay overwrites its
        own), or None for a forward without one."""
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
