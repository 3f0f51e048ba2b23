"""Paged decode attention: CUDA kernels for Hopper and their plain versions.

One query token per sequence attends over a paged KV cache: page pools
k/v (P, page, KV, D), per-sequence block tables (B, n_max) int32, token i
of a sequence at pool[table[i // page], i % page].  Pool index P-1 is the
scrap page that padded and retired rows write into; no live table names it.

Two kernels (``csrc/paged_attention.cu``), each beside a plain PyTorch
version of the same function:

  ``paged_attention``         attend only, given context lengths
                              (plain: ``paged_attention_ref``)
  ``fused_decode_attention``  append this step's K/V row, then attend
                              (plain: ``fused_decode_attention_ref``)

A wrapper checks its arguments, then takes the plain version for tensors
on the CPU and launches the kernel for tensors on a CUDA device; there is
no fallback from one to the other.  ``launches`` counts kernel launches.
Unlike the reference's functional updates, every append here writes the
page pools IN PLACE and returns the same tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# kernel launches per wrapper (plain versions are not counted)
launches: Dict[str, int] = {"paged_attention": 0, "fused_decode_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = (
            [p] * 6 + [i] * 7 + [ctypes.c_float, p])
        lib.paged_attention_launch.restype = i
        lib.fused_decode_attention_launch.argtypes = (
            [p] * 8 + [i] * 7 + [ctypes.c_float, p])
        lib.fused_decode_attention_launch.restype = i
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------
def paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                        scale=None):
    """Decode attention over a paged KV cache, f32 softmax.

    q: (B,H,D); k_pages/v_pages: (P, page, KV, D);
    block_tables: (B, n_max) int32; ctx_lens: (B,) int32.  Returns (B,H,D).
    """
    B, H, D = q.shape
    P, page, KV, _ = k_pages.shape
    n_max = block_tables.shape[1]
    G = H // KV
    scale = scale or D ** -0.5
    tab = block_tables.long()
    k = k_pages[tab].reshape(B, n_max * page, KV, D).float()
    v = v_pages[tab].reshape(B, n_max * page, KV, D).float()
    qf = q.float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) * scale
    pos = torch.arange(n_max * page, device=q.device)
    live = pos[None, :] < ctx_lens[:, None]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v)
    return o.reshape(B, H, D).to(q.dtype)


def paged_kv_append(k_pages, v_pages, k_new, v_new, block_table, start,
                    n=None, scrap_page=None):
    """Chunked-prefill append: scatter a chunk of new KV entries into the
    paged cache, in place.

    k_new/v_new: (C, KV, D) entries for token positions start..start+C-1 of
    ONE sequence whose pages are ``block_table`` ((n_max,) int32).  ``n``
    marks how many of the C rows are real; rows past it go to
    ``scrap_page`` (default P-1), slot 0.  Returns (k_pages, v_pages)."""
    C = k_new.shape[0]
    page = k_pages.shape[1]
    rows = torch.arange(C, device=k_pages.device)
    idx = start + rows
    # positions past the table clamp to its last entry, as the reference's
    # gather does
    slot = torch.clamp(idx // page, max=block_table.shape[0] - 1)
    page_ids = block_table.long()[slot]
    offs = idx % page
    if n is not None:
        pad = rows >= n
        fill = k_pages.shape[0] - 1 if scrap_page is None else scrap_page
        page_ids = torch.where(pad, fill, page_ids)
        offs = torch.where(pad, 0, offs)
    k_pages[page_ids, offs] = k_new.to(k_pages.dtype)
    v_pages[page_ids, offs] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def paged_kv_append_batch(k_pages, v_pages, k_new, v_new, block_tables,
                          positions):
    """Decode-step append, in place: one new KV entry per sequence.

    k_new/v_new: (B, KV, D); block_tables: (B, n_max); positions: (B,) the
    slot each sequence's new token occupies.  Returns (k_pages, v_pages).
    """
    page = k_pages.shape[1]
    pos = positions.long()
    slot = torch.clamp(pos // page, max=block_tables.shape[1] - 1)
    page_ids = block_tables.long().gather(1, slot[:, None])[:, 0]
    offs = pos % page
    k_pages[page_ids, offs] = k_new.to(k_pages.dtype)
    v_pages[page_ids, offs] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def paged_gather(pages, block_table):
    """One sequence's pages as a contiguous (n_max*page, KV, D) tensor
    (positions past the context length must be masked by the caller)."""
    P, page, KV, D = pages.shape
    return pages[block_table.long()].reshape(block_table.shape[0] * page,
                                             KV, D)


def fused_decode_attention_ref(q, k_new, v_new, k_pages, v_pages,
                               block_tables, positions, *, scale=None):
    """Plain version of ``fused_decode_attention``: the batch append, then
    attention over ctx = positions + 1.  Returns (out, k_pages, v_pages)."""
    kp, vp = paged_kv_append_batch(k_pages, v_pages, k_new, v_new,
                                   block_tables, positions)
    out = paged_attention_ref(q, kp, vp, block_tables, positions + 1,
                              scale=scale)
    return out, kp, vp


# ---------------------------------------------------------------------------
# wrappers: check, then plain version on the CPU or kernel on the card
# ---------------------------------------------------------------------------
def _check(q, k_pages, v_pages, block_tables, lens, rows=()):
    """Validate a decode-attention call; ``rows`` are the (B, KV, D) new
    K/V entries of the fused call.  Raises ValueError."""
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                 block_tables=block_tables, lens=lens)
    named.update(zip(("k_new", "v_new"), rows))
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B,H,D) and pools (P,page,KV,D); got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or KV == 0 or H % KV:
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} (need equal pools, same D, "
                         "KV dividing H)")
    for name, t in named.items():
        if name in ("block_tables", "lens"):
            if t.dtype != torch.int32:
                raise ValueError(f"{name} must be int32, got {t.dtype}")
        elif t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported ({_DTYPES})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, n_max), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lens.shape)}")
    for name, t in zip(("k_new", "v_new"), rows):
        if tuple(t.shape) != (B, KV, D):
            raise ValueError(f"{name} must be ({B}, {KV}, {D}), got "
                             f"{tuple(t.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


def _geometry(q, k_pages, block_tables, scale):
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    return (B, H, KV, D, page, block_tables.shape[1],
            int(q.dtype == torch.bfloat16), float(scale or D ** -0.5))


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    scale=None):
    """q: (B,H,D); k/v_pages: (P, page, KV, D); block_tables: (B, n_max)
    int32; ctx_lens: (B,) int32, each >= 1.  Returns (B,H,D)."""
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   ctx_lens, scale=scale)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    with torch.cuda.device(q.device):
        err = _kernels().paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            *_geometry(q, k_pages, block_tables, scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    launches["paged_attention"] += 1
    return out


def fused_decode_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                           positions, *, scale=None):
    """Fused decode step: write each sequence's new KV entry into its page
    and attend over it in one launch (instead of ``paged_kv_append_batch``
    + ``paged_attention``).

    q: (B, H, D); k_new/v_new: (B, KV, D) this step's entries, in the pools'
    dtype; positions: (B,) int32, the slot each entry occupies (context
    length BEFORE the token, so ctx = positions + 1 is attended).  The pools
    are updated in place; only the one target slot per (lane, kv-head) is
    written.  Returns (out (B, H, D), k_pages, v_pages)."""
    _check(q, k_pages, v_pages, block_tables, positions, rows=(k_new, v_new))
    if q.device.type == "cpu":
        return fused_decode_attention_ref(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, positions,
                                          scale=scale)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out, k_pages, v_pages
    with torch.cuda.device(q.device):
        err = _kernels().fused_decode_attention_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(),
            *_geometry(q, k_pages, block_tables, scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_decode_attention launch failed: CUDA error {err}")
    launches["fused_decode_attention"] += 1
    return out, k_pages, v_pages
