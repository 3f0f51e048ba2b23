"""Sharding policy (the reference's ``repro.launch.sharding``): the mesh
placement of the dry run's cells, and serving-side tensor parallelism for
the paged path (DESIGN.md §8): which subsystems shard at a tp degree, how
each resident leaf splits, and the slicing that places one rank's shard.

Mesh placement (DESIGN.md §4), the reference's rules on a
``launch.mesh.Mesh``: ``make_ctx`` (the batch over ('pod', 'data'), the
sequence over 'model'; recurrent-only stacks in training put the batch on
every axis), ``param_pspec`` (``fsdp`` mode: a generic leaf storage-sharded
on its largest dim divisible by data x model, else model, else data;
expert weights pinned to 'model' on the expert dim and 'data' on d_model;
``tp`` mode: Megatron head / d_ff / vocab dims over 'model'),
``opt_shardings``, ``cache_pspec`` (attention caches sequence-sharded, or
head-dim-sharded under decode TP; recurrent states on their feature dim)
and ``batch_shardings``.

Megatron-style: attention projections shard the HEAD dim (q heads stay
grouped with their kv head, H = KV * G, so KV % tp == 0 keeps every GQA
group on one rank and the paged kernels run unchanged on local heads), the
MLP shards d_ff column- and row-wise, and lm_head shards vocab (gathered
exactly, no reduction).  A subsystem whose dim does not divide falls back
to replication; correctness never depends on divisibility.

Specs are plain tuples with, per dim, ``None``, an axis name or a tuple
of axis names, equal to ``tuple(PartitionSpec)`` of the reference's; a
"sharding" is its spec (the port places shards itself, there is no
``NamedSharding``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import tree_map
from repro_torch.models.partition import (AxisCtx, axis_size, best_axes,
                                          entry_axes)

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


# ---------------------------------------------------------------------------
# AxisCtx factory
# ---------------------------------------------------------------------------
def recurrent_only(cfg: ModelConfig) -> bool:
    pats = cfg.prefix_pattern + cfg.unit_pattern
    return all(m in ("mlstm", "slstm") for m, _ in pats)


def make_ctx(cfg: ModelConfig, mesh, phase: str, *, decode_tp: bool = False,
             attn_schedule: str = "rect", attn_chunk: int = 1024,
             ep: bool = True, ep_group=None, fsdp_group=None) -> AxisCtx:
    """The phase's context on ``mesh`` (None: no mesh), with the
    reference's axes.  ``ep_group`` / ``fsdp_group``: a rank's collective
    handles along 'model' and 'data' when the ranks run the expert-parallel
    MoE (``serving.tp.run_grid``)."""
    multi = mesh is not None and "pod" in mesh.shape
    # 'pod' is a pure DP axis (batch); the sequence shards over 'model',
    # except for recurrent-only stacks in training, whose batch absorbs
    # the model axis instead (the reference's EXPERIMENTS.md §Perf)
    if recurrent_only(cfg) and phase == "train":
        batch = ("pod", "data", "model") if multi else ("data", "model")
        seq = ()
    else:
        batch = ("pod", "data") if multi else ("data",)
        seq = ("model",)
    return AxisCtx(mesh=mesh, phase=phase, batch=batch, seq=seq,
                   ep=ep and cfg.num_experts > 0,
                   decode_tp=decode_tp, attn_schedule=attn_schedule,
                   attn_chunk=attn_chunk, ep_group=ep_group,
                   fsdp_group=fsdp_group)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def _generic_spec(mesh, shape) -> tuple:
    """Largest dim divisible by data*model -> ('data','model'); else 'model';
    else 'data'; else replicated."""
    for axes in (("data", "model"), ("model",), ("data",)):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        best, best_dim = -1, None
        for i, s in enumerate(shape):
            if s % n == 0 and s >= n and s > best:
                best, best_dim = s, i
        if best_dim is not None:
            spec = [None] * len(shape)
            spec[best_dim] = tuple(axes) if len(axes) > 1 else axes[0]
            return tuple(spec)
    return (None,) * len(shape)


_ATTN_TP = {  # name -> dim index (after stack strip) sharded over 'model'
    "wq": 2, "wk": 2, "wv": 2,        # (d, H, hd) -> hd
    "wo": 1,                          # (H, hd, d) -> hd
    "w_gate": 1, "w_up": 1,           # (d, f) -> f
    "w_down": 0,                      # (f, d) -> f
    "shared_gate": 1, "shared_up": 1, "shared_down": 0,
    "lm_head": 1,                     # (d, V)
    "w_uk": 0, "w_uv": 0,             # (r, H, ·) -> r?  keep replicated
}


def param_pspec(cfg: ModelConfig, mesh, path, shape,
                mode: str = "fsdp") -> tuple:
    """The spec of the leaf at ``path`` (a tuple of keys) of ``shape``."""
    keys = [str(k) for k in path]
    name = keys[-1]
    stacked = "units" in keys
    inner = tuple(shape[1:]) if stacked else tuple(shape)

    def restack(spec: tuple) -> tuple:
        return (None,) + spec if stacked else spec

    # MoE expert weights: pinned for the EP path.  fsdp mode storage-shards
    # d_model (gathered at use); tp mode (decode) keeps the weights
    # RESIDENT with d_ff sharded over 'data' (tokens gathered)
    is_expert = (cfg.num_experts > 0 and len(inner) == 3
                 and inner[0] == cfg.num_experts
                 and name in ("w_gate", "w_up", "w_down"))
    if is_expert:
        if mode == "tp":
            dm_ix = 2 if name in ("w_gate", "w_up") else 1   # d_ff dim
        else:
            dm_ix = 1 if name in ("w_gate", "w_up") else 2   # d_model dim
        spec = [None, None, None]
        spec[0] = "model"
        if inner[dm_ix] % mesh.shape["data"] == 0:
            spec[dm_ix] = "data"
        return restack(tuple(spec))

    if mode == "tp" and name in _ATTN_TP:
        dim = _ATTN_TP[name]
        if dim < len(inner) and inner[dim] % mesh.shape["model"] == 0 \
                and name not in ("w_uk", "w_uv"):
            spec = [None] * len(inner)
            spec[dim] = "model"
            return restack(tuple(spec))
        return restack((None,) * len(inner))

    return restack(_generic_spec(mesh, inner))


def params_shardings(cfg: ModelConfig, mesh, params_tree,
                     mode: str = "fsdp"):
    """A tree of specs like ``params_tree`` (tensors or anything with
    ``.shape``)."""
    return _map_with_path(
        lambda path, leaf: param_pspec(cfg, mesh, path, tuple(leaf.shape),
                                       mode), params_tree)


def opt_shardings(cfg: ModelConfig, mesh, opt_tree):
    """Optimizer state: the generic divisibility rule per leaf."""
    return _map_with_path(
        lambda path, leaf: _generic_spec(mesh, tuple(leaf.shape)), opt_tree)


# ---------------------------------------------------------------------------
# Cache + input specs
# ---------------------------------------------------------------------------
def cache_pspec(ctx: AxisCtx, path, shape) -> tuple:
    keys = [str(k) for k in path]
    name = keys[-1]
    stacked = "units" in keys
    inner = tuple(shape[1:]) if stacked else tuple(shape)
    mesh = ctx.mesh

    def mk(*dims):
        spec = tuple(best_axes(mesh, s, a) for s, a in zip(inner, dims))
        return (None,) + spec if stacked else spec

    b = ctx.batch
    if name in ("k", "v"):            # (B, S, KV, hd)
        if ctx.decode_tp:
            return mk(b, None, None, ("model",))
        return mk(b, ("model",), None, None)
    if name == "ckv":                 # (B, S, r)
        return mk(b, ("model",), None)
    if name == "kr":                  # (B, S, rope)
        return mk(b, ("model",), None)
    if name == "conv":                # (B, dc-1, di)
        return mk(b, None, ("model",))
    if name == "ssm":                 # (B, di, ds)
        return mk(b, ("model",), None)
    if name == "C":                   # (B, H, dk, dv)
        return mk(b, None, None, ("model",))
    return mk(*([b] + [None] * (len(inner) - 1)))


def cache_shardings(ctx: AxisCtx, cache_tree):
    return _map_with_path(
        lambda path, leaf: cache_pspec(ctx, path, tuple(leaf.shape)),
        cache_tree)


def batch_shardings(ctx: AxisCtx, batch_tree):
    """tokens/labels (B,S) -> (batch, seq); frames/patches (B,S,D)."""
    mesh = ctx.mesh

    def f(path, leaf):
        dims = [ctx.batch, ctx.seq] + [None] * (len(leaf.shape) - 2)
        return tuple(best_axes(mesh, s, a) if a else None
                     for s, a in zip(leaf.shape, dims))

    return _map_with_path(f, batch_tree)


def shard_factor(mesh, spec) -> int:
    """How many ways ``spec`` splits a leaf: the product of the sizes of
    the axes it names."""
    return axis_size(mesh, [a for e in spec for a in entry_axes(e)])


# ---------------------------------------------------------------------------
# Serving-side tensor parallelism for the paged path (DESIGN.md §8)
# ---------------------------------------------------------------------------
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
