"""Logical-axis context threaded through model code (the reference's
``repro.models.partition``).

Mesh fields, as the reference's: ``mesh`` (a ``launch.mesh.Mesh``), the
phase, the mesh axes of the batch and sequence dims, expert parallelism
(``ep``, its axis and the FSDP axis its weights gather over), decode TP
and the attention schedule.  ``launch.sharding.make_ctx`` builds them per
phase; the dry run reads them for its per-device accounting, and
``models.moe.moe_apply`` takes the expert-parallel path from them.
``cs`` / ``hidden`` stay no-ops: in the reference they are layout hints
(``with_sharding_constraint``) to the XLA compiler, which the port does
not have; each of the port's ranks holds its own shard explicitly.

Collective handles.  A rank of a group holds, per subsystem, the handle
its partial results are combined over; None means not sharded there.
Serving tensor parallelism (DESIGN.md §8): ``tp_attn_axis`` (all-reduce
after wo), ``tp_mlp_axis`` (after w_down), ``tp_vocab_axis`` (gather of
vocab-sharded logits).  Expert parallelism: ``ep_group``, the ranks along
``ep_axis`` (the all-to-alls), and ``fsdp_group``, along ``fsdp_axis``
(the weight or token all-gathers and the decode psum).  A handle has
``all_reduce(x)``, ``all_gather(x, dim=-1)`` (the ranks' pieces joined in
rank order), ``all_to_all(x)`` (piece j of dim 0 to rank j), ``rank`` and
``size``; ``repro_torch.serving.tp`` builds them over processes.
``NULL_CTX`` does nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

Axes = Optional[Tuple[str, ...]]


def _sizes(mesh) -> Dict[str, int]:
    return mesh if isinstance(mesh, dict) else mesh.shape


def axis_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` on ``mesh`` (a ``Mesh`` or a dict
    of axis sizes)."""
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes one entry of a spec names: None, a name, or a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def best_axes(mesh, size: int, axes):
    """Longest prefix of ``axes`` whose total size on ``mesh`` (a ``Mesh``
    or a dict of axis sizes) divides ``size``; None if none does."""
    if not axes:
        return None
    for end in range(len(axes), 0, -1):
        cand = tuple(axes[:end])
        if size % axis_size(mesh, cand) == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    mesh: Optional[Any] = None
    phase: str = "train"              # train | prefill | decode
    batch: Axes = None                # mesh axes for the batch dim
    seq: Axes = None                  # mesh axes for the sequence dim
    ep: bool = False                  # expert parallelism
    ep_axis: str = "model"
    fsdp_axis: str = "data"           # expert-weight d gather axis inside EP
    decode_tp: bool = False           # decode: shard head_dim over 'model'
    attn_schedule: str = "rect"       # rect | triangle
    attn_chunk: int = 1024            # kv chunk of the reference's scan
    seq_shard_states: bool = True     # shard recurrent states / caches
    # serving-TP collectives: psum after wo, psum after w_down, and the
    # gather of vocab-sharded logits; None = that subsystem is replicated
    tp_attn_axis: Optional[Any] = None
    tp_mlp_axis: Optional[Any] = None
    tp_vocab_axis: Optional[Any] = None
    # expert parallelism over ranks: the groups along ep_axis / fsdp_axis
    ep_group: Optional[Any] = None
    fsdp_group: Optional[Any] = None

    def cs(self, x, *dims):
        """The reference's sharding constraint: a layout hint to a compiler
        the port does not have, so a no-op."""
        return x

    def hidden(self, x):
        return x

    @property
    def seq_size(self) -> int:
        if self.mesh is None or not self.seq:
            return 1
        return axis_size(self.mesh, self.seq)

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
