"""GQA attention over a paged KV cache (the serving path of the reference's
``repro.models.attention``): chunked prefill in plain PyTorch ops, batched
one-token decode and speculative verification through the paged-attention
kernels.  Page pools are updated in place."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.paged_attention import (NEG_INF,
                                                 fused_decode_attention,
                                                 fused_verify_attention,
                                                 paged_attention, paged_gather,
                                                 paged_kv_append,
                                                 paged_kv_append_batch)
from repro_torch.models.layers import apply_rope, rope_tables


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


def gqa_prefill_paged(x, p, cfg, pages, block_table, start: int, n: int):
    """Chunked-prefill attention for ONE sequence against paged KV.

    x: (1, C, D) chunk hidden states; rows at or past ``n`` are padding,
    their KV goes to the scrap page and their outputs are discarded by the
    caller.  ``block_table``: (n_max,) pages owned by the sequence.
    ``start``: tokens already resident.  The chunk's KV is scattered first,
    then its queries attend over the gathered table under a causal
    position mask, in f32.  Returns (out (1, C, D), pages)."""
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
    return out, {"k": kp, "v": vp}


def gqa_decode_paged(x, p, cfg, pages, block_tables, positions, *,
                     fused=False):
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
    return out, {"k": kp, "v": vp}


def gqa_verify_paged(xs, p, cfg, pages, block_tables, win: VerifyWindow):
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
    outs = [torch.einsum("bhk,hkd->bd", o[r].to(x.dtype), p["wo"])[:, None]
            for r, x in zip(win.take, xs)]
    return outs, {"k": kp, "v": vp}
