"""Layer assembly: a mixer (attention, mamba or xLSTM) + SwiGLU or MoE
blocks, the prefix layers, then ``num_units`` repetitions of the unit
pattern.  Unit parameters, caches
and page pools carry a leading ``num_units`` dim, as in the reference; a
Python loop over units takes the place of ``lax.scan``.  In mode "train"
with ``cfg.remat``, when a gradient is being taken, each unit runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the scan
body): its activations are recomputed in the backward pass, so the flash
forward runs once more per layer there.

Full-sequence forward (``stack_apply``): "attn" (GQA), "mla", "mamba",
"mlstm" and "slstm" mixers, "mlp", "moe" and "none" FFNs; a mixer's decode
writes its cache in place.  Paged serving (``stack_apply_paged``): "attn"
mixers with any of those FFNs.

Mode "verify" (speculative decoding) carries the hidden states as a list
of slabs (S, 1, d) of window rows and runs every row-wise op (norms,
projections, rope, MLP, MoE) once per slab.  GEMM and reduction libraries
choose their summation order by shape, so a verify row then computes
bitwise what an S-lane decode step computes for the same token at the same
position; only attention sees the whole window."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (gqa_apply, gqa_decode_paged,
                                         gqa_prefill_paged, gqa_verify_paged,
                                         mla_apply)
from repro_torch.models.layers import mlp, rms_norm
from repro_torch.models.mamba import mamba_apply
from repro_torch.models.moe import moe_apply
from repro_torch.models.partition import NULL_CTX
from repro_torch.models.xlstm import mlstm_apply, slstm_apply
from repro_torch.obs.spans import NULL_SPANS

MIXERS = {"attn": gqa_apply, "mla": mla_apply, "mamba": mamba_apply,
          "mlstm": mlstm_apply, "slstm": slstm_apply}
FFNS = ("mlp", "moe", "none")


def _ffn(x, lp, ffn, cfg, ctx=NULL_CTX):
    """x plus the layer's FFN of its normed input (none: x).  ``ctx``: the
    dense MLP's serving-TP collective, MoE's expert parallelism (serving
    TP replicates the experts; its context asks for no EP)."""
    if ffn == "none":
        return x
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + (mlp(h, lp, ctx) if ffn == "mlp"
                else moe_apply(h, lp, cfg, ctx))


def layer_apply(x, lp, mixer, ffn, cfg, mode, cache=None, index=None,
                ctx=NULL_CTX):
    """One block of the full-sequence forward; returns (x, cache)."""
    if mixer not in MIXERS:
        raise ValueError(f"the port's full-sequence forward supports "
                         f"{sorted(MIXERS)} mixers, got {mixer!r}")
    if ffn not in FFNS:
        raise ValueError(f"the port's full-sequence forward supports "
                         f"{FFNS} FFNs, got {ffn!r}")
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    mix_out, new_cache = MIXERS[mixer](h, lp, cfg, mode, cache=cache,
                                       index=index)
    return _ffn(x + mix_out, lp, ffn, cfg, ctx), new_cache


def unit_apply(x, unit_params, cfg, mode, unit_caches=None, index=None,
               ctx=NULL_CTX):
    """One repetition of the unit pattern; returns (x, {key: cache})."""
    new_caches = {}
    for i, (mixer, ffn) in enumerate(cfg.unit_pattern):
        key = f"l{i}"
        cache_i = unit_caches[key] if unit_caches is not None else None
        x, new_caches[key] = layer_apply(x, unit_params[key], mixer, ffn,
                                         cfg, mode, cache=cache_i,
                                         index=index, ctx=ctx)
    return x, new_caches


def _unit_slice(tree, u):
    return {key: {name: leaf[u] for name, leaf in layer.items()}
            for key, layer in tree.items()}


def _unit_params(units, n: int):
    """The per-unit parameter dicts of mode "train": each stacked leaf
    unbound once, so its gradient is one stack of the units' gradients
    (slicing it per unit would give each unit's backward a zero-filled
    gradient of the whole stack)."""
    parts = {key: {name: leaf.unbind(0) for name, leaf in layer.items()}
             for key, layer in units.items()}
    return [{key: {name: t[u] for name, t in layer.items()}
             for key, layer in parts.items()} for u in range(n)]


def stack_apply(x, params, cfg, mode, caches=None, index=None,
                ctx=NULL_CTX):
    """The full-sequence stack.  mode "train": returns (x, None); with
    ``cfg.remat``, grad enabled and x or a unit parameter requiring grad,
    each unit is checkpointed.  mode "prefill": returns (x, caches), unit
    caches stacked on a leading num_units dim.  mode "decode": ``caches``
    (as ``Model.init_caches`` makes them) are written in place at
    ``index`` and returned.  ``ctx``: the mesh context (MoE's expert
    parallelism)."""
    new_prefix = []
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        cache_i = caches["prefix"][i] if caches is not None else None
        x, nc = layer_apply(x, params["prefix"][f"l{i}"], mixer, ffn, cfg,
                            mode, cache=cache_i, index=index, ctx=ctx)
        new_prefix.append(nc)
    if mode == "train":
        remat = cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad
                                   for layer in params["units"].values()
                                   for t in layer.values()))
        for up in _unit_params(params["units"], cfg.num_units):
            if remat:
                x, _ = checkpoint(unit_apply, x, up, cfg, mode,
                                  ctx=ctx, use_reentrant=False)
            else:
                x, _ = unit_apply(x, up, cfg, mode, ctx=ctx)
        return x, None
    per_unit = []
    for u in range(cfg.num_units):
        ucache = (_unit_slice(caches["units"], u) if mode == "decode"
                  else None)
        x, nc = unit_apply(x, _unit_slice(params["units"], u), cfg, mode,
                           ucache, index, ctx=ctx)
        per_unit.append(nc)
    if mode == "decode":
        # the unit caches were written in place through their slices
        return x, {"prefix": tuple(new_prefix), "units": caches["units"]}
    units = {key: {name: torch.stack([nc[key][name] for nc in per_unit])
                   for name in per_unit[0][key]}
             for key in per_unit[0]}
    return x, {"prefix": tuple(new_prefix), "units": units}


def layer_apply_paged(x, lp, mixer, ffn, cfg, mode, pages, tables, pos,
                      n=None, fused=False, ctx=NULL_CTX, spans=NULL_SPANS):
    """One paged block; returns (x, pages).  ``spans`` records a prefill or
    decode block's norm and attention as ``layer.attn`` and its FFN as
    ``layer.ffn``."""
    if mixer != "attn":
        raise ValueError(
            f"paged serving supports 'attn' mixers only, got {mixer!r}")
    if ffn not in FFNS:
        raise ValueError(f"paged serving supports {FFNS} FFNs, got "
                         f"{ffn!r}")
    if mode == "verify":
        # the FFN once per slab: each slab is a call of the decode step's
        # shape, so a verify row computes bitwise what a decode row does
        h = [rms_norm(xs, lp["ln1"], cfg.norm_eps) for xs in x]
        mix_out, new_pages = gqa_verify_paged(h, lp, cfg, pages, tables, pos,
                                              ctx)
        return [_ffn(xs + m, lp, ffn, cfg, ctx)
                for xs, m in zip(x, mix_out)], new_pages
    with spans.span("layer.attn"):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if mode == "prefill":
            mix_out, new_pages = gqa_prefill_paged(h, lp, cfg, pages, tables,
                                                   pos, n, ctx)
        elif mode == "decode":
            mix_out, new_pages = gqa_decode_paged(h, lp, cfg, pages, tables,
                                                  pos, fused=fused, ctx=ctx)
        else:
            raise ValueError(f"unknown paged mode {mode!r} "
                             "(prefill | decode | verify)")
    with spans.span("layer.ffn"):
        x = _ffn(x + mix_out, lp, ffn, cfg, ctx)
    return x, new_pages


def stack_apply_paged(x, params, cfg, mode, pages, tables, pos, n=None,
                      fused=False, ctx=NULL_CTX, spans=NULL_SPANS):
    """mode "prefill": ``tables`` is one sequence's (n_max,) block table,
    ``pos`` the chunk's start offset, ``n`` the real chunk length (rows past
    it are padding), each an int or a 0-d int tensor.  mode "decode":
    ``tables`` is (B, n_max), ``pos`` the per-sequence write positions
    (B,).  mode "verify": x is a list of
    slabs (S, 1, d), ``tables`` (B, n_max), ``pos`` the window's
    ``VerifyWindow``.  The pools are written in place.  ``ctx`` carries the
    serving-TP collectives (``models.partition``).  ``spans`` records each
    unit layer's parameter and page views as ``layer.slice``, and the
    spans of ``layer_apply_paged``.  Returns (x, pages)."""
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        x, _ = layer_apply_paged(x, params["prefix"][f"l{i}"], mixer, ffn,
                                 cfg, mode, pages["prefix"][i], tables, pos,
                                 n, fused, ctx, spans)
    for u in range(cfg.num_units):
        for i, (mixer, ffn) in enumerate(cfg.unit_pattern):
            key = f"l{i}"
            with spans.span("layer.slice"):
                lp = {name: leaf[u]
                      for name, leaf in params["units"][key].items()}
                up = {name: leaf[u]
                      for name, leaf in pages["units"][key].items()}
            x, _ = layer_apply_paged(x, lp, mixer, ffn, cfg, mode, up, tables,
                                     pos, n, fused, ctx, spans)
    return x, pages
