"""Attention of the reference's ``repro.models.attention``, in two paths.

Full sequence (``Model.logits`` / ``prefill`` / ``decode_step``): GQA
(``gqa_apply``) and MLA (``mla_apply``).  Their train/prefill attention
goes through ``causal_attention``, one ``flash_attention`` kernel launch
per layer; their one-token decode attends over a contiguous cache in f32
torch ops, as the reference's jnp code does, and writes the cache in
place.

Paged serving: chunked prefill in plain PyTorch ops, batched one-token
decode and speculative verification through the paged-attention kernels.
Page pools are updated in place.  Head counts come from the weights'
shapes, so under serving tensor parallelism a rank runs the same code on
its local heads and ``ctx.psum_attn`` sums the ranks' partial ``wo``
projections."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (NEG_INF,
                                                 fused_decode_attention,
                                                 fused_verify_attention,
                                                 paged_attention, paged_gather,
                                                 paged_kv_append,
                                                 paged_kv_append_batch)
from repro_torch.models.layers import apply_rope, rms_norm, rope_tables
from repro_torch.models.partition import NULL_CTX


class VerifyWindow(NamedTuple):
    """A verify forward's layout (see ``Model.verify_paged``): pos0 and
    widths (B,) int32 and the window width W, as the attention kernel takes
    them; ``rows`` (n_slabs, S) int64, the flat window index b*W + s of
    each slab row (B*W pads); ``take``, the same with padding clamped into
    range for gathers; ``pos`` (n_slabs, S) int32, each slab row's rope
    position."""
    pos0: torch.Tensor
    widths: torch.Tensor
    W: int
    rows: torch.Tensor
    take: torch.Tensor
    pos: torch.Tensor


def _qkv(x, p):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return q, k, v


def _positions(mode, S: int, index, device) -> torch.Tensor:
    """Rope positions: (1,) the decode token's ``index`` (an int or a
    one-element tensor), else arange(S)."""
    if mode != "decode":
        return torch.arange(S, device=device)
    if isinstance(index, torch.Tensor):
        return index.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(index), dtype=torch.long, device=device)


def causal_attention(q, k, v, *, scale):
    """Causal attention of the full-sequence forward: query i attends keys
    0..i.  q: (B,S,H,Dk); k: (B,S,KV,Dk); v: (B,S,KV,Dv), all contiguous.
    Returns (B,S,H,Dv) in q's dtype.

    One ``flash_attention`` launch.  The reference's ``rect`` and
    ``triangle`` schedules are XLA sharding and FLOP strategies for this
    one function; the kernel's key loop stops at the causal diagonal, which
    is what ``triangle`` buys, so the port has no schedules."""
    return flash_attention(q, k, v, causal=True, scale=scale)


def _decode_mask(pos, S: int):
    """(S,) True where a cache slot is at or before the decode position."""
    return torch.arange(S, device=pos.device) <= pos


def gqa_apply(x, p, cfg, mode, cache=None, index=None):
    """GQA attention of the full-sequence forward.  x: (B,S,D) normed.

    mode "train" / "prefill": causal attention over the S positions through
    ``causal_attention``; prefill returns the cache {"k", "v"} (B,S,KV,Dh).
    mode "decode": S == 1; the token's K/V is written IN PLACE into
    ``cache`` (B,Smax,KV,Dh) at ``index`` (< Smax), then it attends over
    slots 0..index in f32.  Returns (out (B,S,D), cache or None)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(x, p)
    pos = _positions(mode, S, index, x.device)
    if cfg.positional == "rope":
        cos, sin = rope_tables(pos, Dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = Dh ** -0.5
    if mode in ("train", "prefill"):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = causal_attention(q, k, v, scale=scale)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    elif mode == "decode":
        ck, cv = cache["k"], cache["v"]
        ck.index_copy_(1, pos, k.to(ck.dtype))
        cv.index_copy_(1, pos, v.to(cv.dtype))
        qg = q.reshape(B, 1, KV, H // KV, Dh).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck.float()) * scale
        s = s.masked_fill(~_decode_mask(pos, ck.shape[1]), NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", w, cv.float())
        o = o.reshape(B, 1, H, Dh)
        new_cache = {"k": ck, "v": cv}
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    return out, new_cache


def _mla_q(x, p, cfg):
    """MLA queries (B,S,H, nope+rope), through the q LoRA when it has one."""
    if cfg.q_lora_rank:
        cq = rms_norm(x @ p["w_dq"], p["q_ln"], cfg.norm_eps)
        return torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    return torch.einsum("bsd,dhk->bshk", x, p["w_q"])


def mla_apply(x, p, cfg, mode, cache=None, index=None):
    """MLA (multi-head latent attention) of the full-sequence forward.
    x: (B,S,D) normed.

    mode "train" / "prefill": per-head K/V are materialised from the latent
    (k = [k_nope, k_rope], Dk = nope + rope; v of v_head_dim) and attended
    through ``causal_attention``; prefill returns the cache {"ckv" (B,S,r),
    "kr" (B,S,rope)}.  mode "decode": the absorbed form, in f32: the token's
    latent and rope key are written IN PLACE into ``cache`` at ``index``,
    queries are absorbed through w_uk and outputs expanded through w_uv.
    Returns (out (B,S,D), cache or None)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (nope + rope_d) ** -0.5
    q = _mla_q(x, p, cfg)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = rms_norm(x @ p["w_dkv"], p["kv_ln"], cfg.norm_eps)    # (B,S,r)
    k_rope = (x @ p["w_kr"])[:, :, None, :]                     # (B,S,1,rope)
    pos = _positions(mode, S, index, x.device)
    cos, sin = rope_tables(pos, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    if mode in ("train", "prefill"):
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
        v = torch.einsum("bsr,rhv->bshv", ckv, p["w_uv"]).contiguous()
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rope_d).to(
            k_nope.dtype)], dim=-1)
        qq = torch.cat([q_nope, q_rope.to(q_nope.dtype)], dim=-1)
        o = causal_attention(qq, k, v, scale=scale)             # (B,S,H,vd)
        new_cache = ({"ckv": ckv, "kr": k_rope[:, :, 0, :]}
                     if mode == "prefill" else None)
    elif mode == "decode":
        cc, ckr = cache["ckv"], cache["kr"]
        cc.index_copy_(1, pos, ckv.to(cc.dtype))
        ckr.index_copy_(1, pos, k_rope[:, :, 0, :].to(ckr.dtype))
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope.float(),
                             p["w_uk"].float())                 # (B,1,H,r)
        s = (torch.einsum("bthr,bsr->bhts", q_abs, cc.float())
             + torch.einsum("bthp,bsp->bhts", q_rope.float(),
                            ckr.float())) * scale
        s = s.masked_fill(~_decode_mask(pos, cc.shape[1]), NEG_INF)
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhts,bsr->bthr", w, cc.float())
        o = torch.einsum("bthr,rhv->bthv", o_lat, p["w_uv"].float())
        new_cache = {"ckv": cc, "kr": ckr}
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    out = torch.einsum("bshv,hvd->bsd", o.to(x.dtype), p["wo"])
    return out, new_cache


def gqa_prefill_paged(x, p, cfg, pages, block_table, start, n,
                      ctx=NULL_CTX):
    """Chunked-prefill attention for ONE sequence against paged KV.

    x: (1, C, D) chunk hidden states; rows at or past ``n`` are padding,
    their KV goes to the scrap page and their outputs are discarded by the
    caller.  ``block_table``: (n_max,) pages owned by the sequence.
    ``start``: tokens already resident.  ``start`` and ``n`` are ints or
    0-d int tensors on x's device (the same ops either way).  The chunk's
    KV is scattered first, then its queries attend over the gathered table
    under a causal position mask, in f32.  Returns (out (1, C, D),
    pages)."""
    B, C, D = x.shape
    H, KV, Dh = p["wq"].shape[1], p["wk"].shape[1], p["wq"].shape[2]
    G = H // KV
    q, k, v = _qkv(x, p)
    pos = start + torch.arange(C, device=x.device)
    if cfg.positional == "rope":
        cos, sin = rope_tables(pos, Dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kp, vp = paged_kv_append(pages["k"], pages["v"], k[0], v[0],
                             block_table, start, n=n)
    keys = paged_gather(kp, block_table)                # (L, KV, Dh)
    vals = paged_gather(vp, block_table)
    L = keys.shape[0]
    qg = q.reshape(B, C, KV, G, Dh).float()
    s = torch.einsum("bckgd,lkd->bckgl", qg, keys.float()) * (Dh ** -0.5)
    live = torch.arange(L, device=x.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~live[None, :, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bckgl,lkd->bckgd", w, vals.float())
    o = o.reshape(B, C, H, Dh)
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    return ctx.psum_attn(out), {"k": kp, "v": vp}


def gqa_decode_paged(x, p, cfg, pages, block_tables, positions, *,
                     fused=False, ctx=NULL_CTX):
    """Batched one-token decode against paged KV.

    x: (B, 1, D); block_tables: (B, n_max) int32; positions: (B,) int32,
    the slot the new token's KV occupies (context length BEFORE it); rope
    is applied per sequence.  ``fused=True`` takes the one-launch
    append+attend kernel; ``fused=False`` appends with tensor indexing and
    attends with ``paged_attention``.  Returns (out (B, 1, D), pages)."""
    Dh = p["wq"].shape[2]
    q, k, v = _qkv(x, p)
    if cfg.positional == "rope":
        cos, sin = rope_tables(positions[:, None], Dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if fused:
        o, kp, vp = fused_decode_attention(
            q[:, 0], k[:, 0], v[:, 0], pages["k"], pages["v"],
            block_tables, positions, scale=Dh ** -0.5)
    else:
        kp, vp = paged_kv_append_batch(pages["k"], pages["v"],
                                       k[:, 0], v[:, 0],
                                       block_tables, positions)
        o = paged_attention(q[:, 0], kp, vp, block_tables, positions + 1,
                            scale=Dh ** -0.5)
    out = torch.einsum("bhk,hkd->bd", o.to(x.dtype), p["wo"])[:, None, :]
    return ctx.psum_attn(out), {"k": kp, "v": vp}


def gqa_verify_paged(xs, p, cfg, pages, block_tables, win: VerifyWindow,
                     ctx=NULL_CTX):
    """Speculative verification attention: W window rows per lane, one
    ``fused_verify_attention`` launch.

    xs: slabs (S, 1, D) of window rows as ``win.rows`` lays them out (row 0
    of a lane the last accepted token, rows 1.. the drafts).  Projections
    and rope run per slab, each in the shape of an S-lane
    ``gqa_decode_paged`` call, so every row's q/k/v and output projection
    are bitwise the decode step's at that position; q/k/v are scattered
    into the (B, W) window (rows not computed stay 0 and, past a lane's
    width, are never read) and the outputs gathered back.  Returns (slabs
    (S, 1, D), pages)."""
    Dh = p["wq"].shape[2]
    B, W = win.pos0.shape[0], win.W
    parts = []
    for x, pos in zip(xs, win.pos):
        q, k, v = _qkv(x, p)
        if cfg.positional == "rope":
            cos, sin = rope_tables(pos[:, None], Dh, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        parts.append((q[:, 0], k[:, 0], v[:, 0]))
    rows = win.rows.reshape(-1)

    def window(slabs):
        t = torch.cat(slabs)
        out = t.new_zeros((B * W + 1,) + t.shape[1:])
        out[rows] = t
        return out[:B * W].view((B, W) + t.shape[1:])

    q, k, v = (window(slabs) for slabs in zip(*parts))
    o, kp, vp = fused_verify_attention(q, k, v, pages["k"], pages["v"],
                                       block_tables, win.pos0, win.widths,
                                       scale=Dh ** -0.5)
    o = o.view((B * W,) + o.shape[2:])
    outs = [ctx.psum_attn(
        torch.einsum("bhk,hkd->bd", o[r].to(x.dtype), p["wo"])[:, None])
        for r, x in zip(win.take, xs)]
    return outs, {"k": kp, "v": vp}
