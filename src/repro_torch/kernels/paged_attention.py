"""Paged decode attention: CUDA kernels for Hopper and their plain versions.

One query token per sequence attends over a paged KV cache: page pools
k/v (P, page, KV, D), per-sequence block tables (B, n_max) int32, token i
of a sequence at pool[table[i // page], i % page].  Pool index P-1 is the
scrap page that padded and retired rows write into; no live table names it.

Three kernels (``csrc/paged_attention.cu``), each beside a plain PyTorch
version of the same function:

  ``paged_attention``         attend only, given context lengths
                              (plain: ``paged_attention_ref``)
  ``fused_decode_attention``  append this step's K/V row, then attend
                              (plain: ``fused_decode_attention_ref``)
  ``fused_verify_attention``  speculative verification: append W window
                              rows per lane, then attend each row under its
                              own causal length (plain:
                              ``fused_verify_attention_ref``, W chained
                              ``fused_decode_attention_ref`` calls)

The three kernels are one CUDA body: ``fused_decode_attention`` is it at
one window row, ``paged_attention`` at one row with every token read from
the pools, so their outputs are bitwise equal to each other and to the
verify kernel's live rows at the same positions.  A block covers one chunk
of ``CHUNK`` consecutive tokens; rows longer than a chunk are merged from
f32 partials by the last block of their group (``blocking``).

A wrapper checks its arguments, then takes the plain version for tensors
on the CPU (or on ``meta``, where nothing runs: the dry run's shapes) and
launches the kernel for tensors on a CUDA device; there is no fallback
from one to the other.  ``launches`` counts kernel launches.  Under a
``launch.roofline.CostCounter`` a wrapper reports its analytic FLOPs and
bytes (``kernels.cost``).
Unlike the reference's functional updates, every append here writes the
page pools IN PLACE and returns the same tensors.  A launch reads nothing
back to the host; the chunk counters it uses are per device, so the
kernels of one device run on one stream at a time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from repro_torch.kernels import build, cost

NEG_INF = -1e30

# kernel launches per wrapper (plain versions are not counted)
launches: Dict[str, int] = {"paged_attention": 0, "fused_decode_attention": 0,
                            "fused_verify_attention": 0}
cost.LAUNCHES.append(launches)
# devices on which a wrapper runs the plain version (on ``meta`` it computes
# nothing: shapes alone, for the dry run)
PLAIN = ("cpu", "meta")

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None

# the kernels' blocks: 8 warps, 64-token tiles in a two-stage ring, at
# most this much dynamic shared memory (an H100 block's); a block covers
# CHUNK consecutive tokens (the kernel's kChunk)
WARPS = 8
TILE = 64
STAGES = 2
MAX_SMEM = 232448
CHUNK = 128

# zeroed int32 counters per device, one per (lane, kv-head, task group) of
# a launch; the last block of each group resets its counter to 0.  Every
# buffer handed to a launch is kept, the newest last: a CUDA graph that
# captured a launch reads its buffer at that address after a wider launch
# has taken a bigger one
_tickets: Dict[torch.device, List[torch.Tensor]] = {}


def ticket_sum() -> int:
    """The ticket counters' absolute values summed over every buffer of
    every device of this process: 0 whenever no launch is in flight."""
    return sum(int(t.abs().sum()) for ts in _tickets.values() for t in ts)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a built ``paged_attention`` library
    and check that its chunk length is ``CHUNK``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, p, p, p]                      # per, part, tickets, stream
    lib.paged_attention_launch.argtypes = [p] * 6 + [i] * 7 + [f] + tail
    lib.fused_decode_attention_launch.argtypes = [p] * 8 + [i] * 7 + [f] + tail
    lib.fused_verify_attention_launch.argtypes = [p] * 9 + [i] * 8 + [f] + tail
    lib.fused_verify_smem_bytes.argtypes = [i, i, i]
    lib.paged_chunk_tokens.argtypes = []
    for fn in ("paged_attention_launch", "fused_decode_attention_launch",
               "fused_verify_attention_launch", "fused_verify_smem_bytes",
               "paged_chunk_tokens"):
        getattr(lib, fn).restype = i
    if lib.paged_chunk_tokens() != CHUNK:
        raise RuntimeError(f"paged_attention library covers "
                           f"{lib.paged_chunk_tokens()} tokens a block, "
                           f"the wrapper {CHUNK}")
    return lib


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _bind(build.load("paged_attention"))
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
    ``scrap_page`` (default P-1), slot 0.  ``start`` and ``n`` are ints or
    0-d int tensors on the pages' device.  Returns (k_pages, v_pages)."""
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


def fused_verify_attention_ref(q, k_new, v_new, k_pages, v_pages,
                               block_tables, pos0, widths, *, scale=None):
    """Plain version of ``fused_verify_attention``, as the reference's
    ``_verify_unrolled``: W chained ``fused_decode_attention_ref`` calls
    through the pools, row s at positions pos0 + s.  Rows at or past a
    lane's width run on the all-scrap table, so their K/V lands on the
    scrap page and their outputs are garbage the caller discards.
    Returns (out (B, W, H, D), k_pages, v_pages)."""
    W = q.shape[1]
    scrap = torch.full_like(block_tables, k_pages.shape[0] - 1)
    outs = []
    for s in range(W):
        tab_s = torch.where(widths[:, None] > s, block_tables, scrap)
        o, k_pages, v_pages = fused_decode_attention_ref(
            q[:, s], k_new[:, s], v_new[:, s], k_pages, v_pages, tab_s,
            pos0 + s, scale=scale)
        outs.append(o)
    return torch.stack(outs, dim=1), k_pages, v_pages


# ---------------------------------------------------------------------------
# wrappers: check, then plain version on the CPU or kernel on the card
# ---------------------------------------------------------------------------
def _check(q, k_pages, v_pages, block_tables, lens, rows=(), widths=None):
    """Validate a decode-attention call; ``rows`` are the new K/V entries of
    a fused call, (B, KV, D).  With ``widths`` ((B,) int32) it is a verify
    call: q is (B, W, H, D) and the rows (B, W, KV, D).  Raises
    ValueError."""
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                 block_tables=block_tables, lens=lens)
    named.update(zip(("k_new", "v_new"), rows))
    lead = 1
    if widths is not None:
        named["widths"] = widths
        lead = 2
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != lead + 2 or k_pages.dim() != 4:
        want = "(B,W,H,D)" if widths is not None else "(B,H,D)"
        raise ValueError(f"q must be {want} and pools (P,page,KV,D); got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    P, page, KV, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or KV == 0 or H % KV:
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} (need equal pools, same D, "
                         "KV dividing H)")
    for name, t in named.items():
        if name in ("block_tables", "lens", "widths"):
            if t.dtype != torch.int32:
                raise ValueError(f"{name} must be int32, got {t.dtype}")
        elif t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported ({_DTYPES})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, n_max), got "
                         f"{tuple(block_tables.shape)}")
    for name in ("lens", "widths"):
        t = named.get(name)
        if t is not None and tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    for name, t in zip(("k_new", "v_new"), rows):
        if tuple(t.shape) != q.shape[:lead] + (KV, D):
            raise ValueError(f"{name} must be {q.shape[:lead] + (KV, D)}, "
                             f"got {tuple(t.shape)}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")


def _rows(D: int, elem: int):
    """Bytes of one staged (K row, V row): D elements rounded up to 16
    bytes, a K row padded by 16 more where that makes its length an odd
    number of 16-byte units (``csrc/paged_attention.cu``, ``k_row_bytes``
    / ``v_row_bytes``)."""
    v = -(-D * elem // 16) * 16
    return (v if (v // 16) % 2 else v + 16), v


def verify_smem_bytes(per: int, D: int, elem: int) -> int:
    """Dynamic shared memory of a block of ``per`` tasks at head dim D and
    ``elem`` bytes per element: two ring stages of 64 K and V rows, then
    each warp's 64 f32 probabilities, f32 q and acc rows and (m, l) per
    task (the kernel's ``smem_bytes``)."""
    kr, vr = _rows(D, elem)
    return STAGES * TILE * (kr + vr) + 4 * (WARPS * TILE + 2 * per * D
                                            + 2 * per)


def chunk_starts(n_max: int, page: int):
    """First token of each chunk a lane's table holds: 0, CHUNK, 2*CHUNK,
    ... below its capacity n_max * page (one chunk at least)."""
    return list(range(0, max(1, n_max * page), CHUNK))


def blocking(W: int, G: int, D: int, elem: int, n_max: int, page: int):
    """How the kernel splits a (lane, kv-head)'s work over blocks: its W*G
    tasks (one window row of one query head each) into groups of ``per``,
    enough for a block's 8 warps (G of them a warp each where G exceeds 8)
    and no more, fewer where shared memory runs out; its table's capacity
    into chunks of ``CHUNK`` tokens.  Returns (per, task groups, chunks,
    shared memory bytes per block, partial bytes per (lane, kv-head)): a
    block per (group, chunk), and f32 (m, l, acc[D]) per task and chunk
    where there is more than one chunk.  Raises ValueError where not even
    one task fits."""
    tasks = W * G
    per = min(tasks, WARPS * -(-G // WARPS))
    while per > 1 and verify_smem_bytes(per, D, elem) > MAX_SMEM:
        per -= 1
    smem = verify_smem_bytes(per, D, elem)
    if smem > MAX_SMEM:
        raise ValueError(f"paged attention: head dim {D} needs {smem} B of "
                         f"shared memory per block, more than {MAX_SMEM}")
    chunks = len(chunk_starts(n_max, page))
    partial = 4 * (D + 2) * tasks * chunks if chunks > 1 else 0
    return per, -(-tasks // per), chunks, smem, partial


def _launch(name, q, k_pages, block_tables, scale, ptrs):
    """Launch kernel ``name`` (C entry point ``<name>_launch`` of the shared
    body) on the tensors whose pointers are ``ptrs``, then B, for a verify
    call W, the geometry, per, the partials, the counters and the stream.
    Raises RuntimeError if CUDA refuses the launch."""
    lead = tuple(q.shape[:-2])                  # (B,) or, to verify, (B, W)
    B, W = lead[0], (lead[1] if len(lead) == 2 else 1)
    H, D = q.shape[-2:]
    _, page, KV, _ = k_pages.shape
    n_max = block_tables.shape[1]
    per, groups, chunks, _, partial = blocking(W, H // KV, D,
                                               q.element_size(), n_max, page)
    part = tickets = None
    if chunks > 1:
        part = torch.empty(B * KV * partial // 4, dtype=torch.float32,
                           device=q.device)
        need = B * KV * groups
        held = _tickets.setdefault(q.device, [])
        if not held or held[-1].numel() < need:
            held.append(torch.zeros(need, dtype=torch.int32,
                                    device=q.device))
        tickets = held[-1]
    with torch.cuda.device(q.device):
        err = getattr(_kernels(), f"{name}_launch")(
            *ptrs, *lead, H, KV, D, page, n_max,
            int(q.dtype == torch.bfloat16), float(scale or D ** -0.5),
            per, None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def _attend_cost(q, k_pages, block_tables, pairs: int, kv_tokens: int,
                 rows: int, new_rows: int):
    """(flops, bytes) of a paged call: ``pairs`` (query row, key) pairs per
    head, q.k and p.v at 2 * D operations each; the K/V of ``kv_tokens``
    tokens read once, ``rows`` query rows read and written once,
    ``new_rows`` K/V rows read and written, and the block tables and
    lengths read (the kernels' bounds in ``chip_smoke.py``)."""
    H, D = q.shape[-2:]
    KV, e = k_pages.shape[2], q.element_size()
    B = block_tables.shape[0]
    flops = 4 * H * D * pairs
    nbytes = (2 * kv_tokens * KV * D * e + 2 * rows * H * D * e
              + 4 * new_rows * KV * D * e + 4 * block_tables.numel() + 4 * B)
    return flops, nbytes


def _paged_cost(q, k_pages, v_pages, block_tables, ctx_lens, *, scale=None):
    cap = block_tables.shape[1] * k_pages.shape[1]
    n = cost.lengths_sum(ctx_lens, cap)
    return _attend_cost(q, k_pages, block_tables, n, n, q.shape[0], 0)


def _decode_cost(q, k_new, v_new, k_pages, v_pages, block_tables, positions,
                 *, scale=None):
    cap = block_tables.shape[1] * k_pages.shape[1]
    n = cost.lengths_sum(positions, cap - 1) + positions.numel()
    return _attend_cost(q, k_pages, block_tables, n, n, q.shape[0],
                        q.shape[0])


def _verify_cost(q, k_new, v_new, k_pages, v_pages, block_tables, pos0,
                 widths, *, scale=None):
    """Row s of lane b (s < widths[b]) attends pos0[b] + s + 1 tokens; a
    lane's K/V is read once, up to its last live row."""
    B, W = q.shape[:2]
    cap = block_tables.shape[1] * k_pages.shape[1]
    if pos0.device.type == "meta":
        pairs, kv, live = B * W * cap, B * cap, B * W
    else:
        p0, w = pos0.long().cpu(), widths.long().cpu()
        pairs = int((w * p0 + w * (w + 1) // 2).sum())
        kv = int(((p0 + w) * (w > 0)).sum())
        live = int(w.sum())
    return _attend_cost(q, k_pages, block_tables, pairs, kv, B * W, live)


@cost.counted("paged_attention", _paged_cost)
def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    scale=None):
    """q: (B,H,D); k/v_pages: (P, page, KV, D); block_tables: (B, n_max)
    int32; ctx_lens: (B,) int32, each >= 1.  Returns (B,H,D)."""
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    if q.device.type in PLAIN:
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   ctx_lens, scale=scale)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    _launch("paged_attention", q, k_pages, block_tables, scale,
            (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr()))
    return out


@cost.counted("fused_decode_attention", _decode_cost)
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
    if q.device.type in PLAIN:
        return fused_decode_attention_ref(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, positions,
                                          scale=scale)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out, k_pages, v_pages
    _launch("fused_decode_attention", q, k_pages, block_tables, scale,
            (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
             positions.data_ptr(), out.data_ptr()))
    return out, k_pages, v_pages


@cost.counted("fused_verify_attention", _verify_cost)
def fused_verify_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                           pos0, widths, *, scale=None):
    """Speculative verification in one launch: for each lane b, write the
    K/V of window rows s < widths[b] at positions pos0[b] + s, then attend
    query row s over its first pos0[b] + s + 1 tokens.

    q: (B, W, H, D); k_new/v_new: (B, W, KV, D) in the pools' dtype; pos0:
    (B,) int32, row 0's slot (the context length before the window);
    widths: (B,) int32, live rows per lane (0 for padding lanes).  Each live
    row's output is bitwise the ``fused_decode_attention`` kernel's at that
    position.  Rows at or past the width write nothing; their output rows
    are unspecified, and the caller discards them.  The pools are updated
    in place.  Returns (out (B, W, H, D), k_pages, v_pages)."""
    _check(q, k_pages, v_pages, block_tables, pos0, rows=(k_new, v_new),
           widths=widths)
    if q.device.type in PLAIN:
        return fused_verify_attention_ref(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, pos0, widths,
                                          scale=scale)
    out = torch.empty_like(q)
    if q.numel():
        _launch("fused_verify_attention", q, k_pages, block_tables, scale,
                (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), pos0.data_ptr(), widths.data_ptr(),
                 out.data_ptr()))
    return out, k_pages, v_pages
