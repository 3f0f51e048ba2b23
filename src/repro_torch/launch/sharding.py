"""Serving-side tensor parallelism for the paged path (the reference's
``repro.launch.sharding``, DESIGN.md §8): which subsystems shard at a tp
degree, how each resident leaf splits, and the slicing that places one
rank's shard.

Megatron-style: attention projections shard the HEAD dim (q heads stay
grouped with their kv head, H = KV * G, so KV % tp == 0 keeps every GQA
group on one rank and the paged kernels run unchanged on local heads), the
MLP shards d_ff column- and row-wise, and lm_head shards vocab (gathered
exactly, no reduction).  A subsystem whose dim does not divide falls back
to replication; correctness never depends on divisibility.

Specs are plain tuples with ``None`` or ``"model"`` per dim, equal to
``tuple(PartitionSpec)`` of the reference's.  The reference's mesh
placement of training and dry-run cells (``make_ctx``, ``param_pspec``,
``cache_pspec``) has no counterpart here yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import tree_map
from repro_torch.models.partition import AxisCtx

_PAGED_TP_ATTN = {"wq": 1, "wk": 1, "wv": 1,   # (d, H|KV, hd) -> heads
                  "wo": 0}                     # (H, hd, d)    -> heads
_PAGED_TP_MLP = {"w_gate": 1, "w_up": 1,       # (d, f)  -> f
                 "w_down": 0}                  # (f, d)  -> f


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def paged_tp_plan(cfg: ModelConfig, tp: int) -> dict:
    """Which subsystems shard at this tp degree.

    attn  - KV heads (and with them the paged KV pool and the q-head
            groups); needs num_kv_heads % tp == 0.
    mlp   - d_ff (dense MLP only; MoE experts stay replicated).
    vocab - lm_head columns.
    """
    if tp <= 1:
        return dict(tp=max(tp, 1), attn=False, mlp=False, vocab=False)
    return dict(
        tp=tp,
        attn=cfg.num_kv_heads % tp == 0,
        mlp=cfg.d_ff > 0 and cfg.num_experts == 0 and cfg.d_ff % tp == 0,
        vocab=cfg.vocab_padded % tp == 0)


def paged_param_specs(cfg: ModelConfig, tp: int, params_tree):
    """Spec tree for resident serving weights under the plan.  Works on
    tensors, arrays or anything with ``.ndim``."""
    plan = paged_tp_plan(cfg, tp)

    def f(path, leaf):
        name = path[-1]
        stacked = "units" in path
        nd = leaf.ndim - (1 if stacked else 0)
        dim = None
        if plan["attn"] and name in _PAGED_TP_ATTN:
            dim = _PAGED_TP_ATTN[name]
        elif plan["mlp"] and name in _PAGED_TP_MLP:
            dim = _PAGED_TP_MLP[name]
        elif plan["vocab"] and name == "lm_head":
            dim = 1
        spec = [None] * nd
        if dim is not None and dim < nd:
            spec[dim] = "model"
        return tuple([None] + spec) if stacked else tuple(spec)

    return _map_with_path(f, params_tree)


def paged_page_specs(cfg: ModelConfig, tp: int, pages_tree):
    """Spec tree for the paged KV pool: every leaf is a k/v pool (num_pages,
    page, KV, hd), stacked units with a leading num_units dim; the KV-head
    dim (ndim-2) shards when the plan shards attention."""
    plan = paged_tp_plan(cfg, tp)

    def f(leaf):
        spec = [None] * leaf.ndim
        if plan["attn"]:
            spec[leaf.ndim - 2] = "model"
        return tuple(spec)

    return tree_map(f, pages_tree)


def serving_tp_ctx(cfg: ModelConfig, tp: int, group: Any) -> AxisCtx:
    """AxisCtx for one rank of a tp-way serving group: ``group`` (a
    collective handle, see ``models.partition``) for each subsystem the
    plan shards, None for the replicated ones."""
    plan = paged_tp_plan(cfg, tp)
    return AxisCtx(tp_attn_axis=group if plan["attn"] else None,
                   tp_mlp_axis=group if plan["mlp"] else None,
                   tp_vocab_axis=group if plan["vocab"] else None)


def shard_leaf(leaf, spec, rank: int, tp: int):
    """Rank ``rank``'s piece of ``leaf`` under ``spec``: the slice of every
    "model" dim, as a contiguous tensor (or array) of its own, never a view
    that keeps the full leaf alive; a replicated leaf is returned as is."""
    if "model" not in spec:
        return leaf
    idx = []
    for dim, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        n = leaf.shape[dim]
        if n % tp:
            raise ValueError(f"dim {dim} of size {n} does not divide by "
                             f"tp={tp}")
        w = n // tp
        idx.append(slice(rank * w, (rank + 1) * w))
    piece = leaf[tuple(idx)]
    if isinstance(piece, torch.Tensor):
        return piece.clone(memory_format=torch.contiguous_format)
    return np.array(piece, copy=True, order="C")


def shard_tree(tree, specs, rank: int, tp: int):
    """The counterpart of ``jax.device_put`` with ``NamedSharding`` for one
    rank: every leaf's slice under its spec (see ``shard_leaf``)."""
    return tree_map(lambda leaf, spec: shard_leaf(leaf, spec, rank, tp),
                    tree, specs)
