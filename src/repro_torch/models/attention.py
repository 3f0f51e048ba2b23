"""GQA attention over a paged KV cache (the serving path of the reference's
``repro.models.attention``): chunked prefill in plain PyTorch ops, batched
one-token decode through the paged-attention kernels.  Page pools are
updated in place."""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import (NEG_INF,
                                                 fused_decode_attention,
                                                 paged_attention, paged_gather,
                                                 paged_kv_append,
                                                 paged_kv_append_batch)
from repro_torch.models.layers import apply_rope, rope_tables


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
