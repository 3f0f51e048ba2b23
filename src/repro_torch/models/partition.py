"""Axis context threaded through the paged serving path (the reference's
``repro.models.partition``, serving side).

Under serving tensor parallelism (DESIGN.md §8) every rank runs the paged
entry points on its shard of the weights and of the page pool.  The
context's ``tp_*`` fields name, per subsystem, the collective handle its
partial results are combined over; None means the subsystem is replicated
at this tp degree (e.g. attention when ``num_kv_heads % tp != 0``) and its
collective is a no-op.  A handle has ``all_reduce(x)`` (sum over the ranks,
returning the result) and ``all_gather(x)`` (the ranks' pieces concatenated
along the last dim, in rank order); ``repro_torch.serving.tp.DataGroup`` is
the one the backend builds over ``torch.distributed``.

The reference's mesh fields (batch / sequence sharding constraints, expert
parallelism) constrain XLA's layout of a compiled program; the port keeps
``best_axes`` and the ``cs`` / ``hidden`` entry points as no-ops until it
has a mesh of its own.  ``NULL_CTX`` does nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


def best_axes(mesh_shape: Dict[str, int], size: int, axes):
    """Longest prefix of ``axes`` whose total size (``mesh_shape`` maps an
    axis name to its size) divides ``size``; None if none does."""
    if not axes:
        return None
    for end in range(len(axes), 0, -1):
        cand = tuple(axes[:end])
        n = 1
        for a in cand:
            n *= mesh_shape[a]
        if size % n == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    # serving-TP collectives: psum after wo, psum after w_down, and the
    # gather of vocab-sharded logits; None = that subsystem is replicated
    tp_attn_axis: Optional[Any] = None
    tp_mlp_axis: Optional[Any] = None
    tp_vocab_axis: Optional[Any] = None

    def cs(self, x, *dims):
        """The reference's sharding constraint; a no-op without a mesh."""
        return x

    def hidden(self, x):
        return x

    def psum_attn(self, x):
        """All-reduce attention-output partial sums (wo is row-sharded over
        heads, so each rank holds a partial projection)."""
        if self.tp_attn_axis is None:
            return x
        return self.tp_attn_axis.all_reduce(x)

    def psum_mlp(self, x):
        """All-reduce MLP down-projection partial sums (w_down is
        row-sharded over d_ff)."""
        if self.tp_mlp_axis is None:
            return x
        return self.tp_mlp_axis.all_reduce(x)

    def gather_vocab(self, logits):
        """Reassemble vocab-sharded logits; exact, every column computed as
        on one device."""
        if self.tp_vocab_axis is None:
            return logits
        return self.tp_vocab_axis.all_gather(logits)


NULL_CTX = AxisCtx()
