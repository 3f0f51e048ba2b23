"""The paged kernels' split over the context, on the CPU: the host-side
blocking (``repro_torch.kernels.paged_attention.blocking``) covers every
(row, head) task once and fits a block's shared memory, chunk offsets are
fixed multiples of ``CHUNK``, the byte counts follow the kernel's layout,
and a plain-torch emulation of the kernel's arithmetic (64-token tiles
inside chunks of C tokens, f32 partials merged in chunk order) agrees with
the plain version and with the JAX package's Pallas kernels in interpret
mode within f32 1e-5 at contexts around chunk edges and at the table's
capacity.  The emulation lives here, not in the package: the kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    fused_decode_attention as j_fused, paged_attention as j_paged)
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

ATOL = 1e-5
TILE = 64


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("G", [1, 3, 7, 8])
def test_blocking_covers_every_task_and_fits(D, elem, G):
    """For every window the wrapper admits (W <= 9) and tables from one
    page to 4096 tokens: each task in exactly one group, no group empty,
    shared memory within a block's limit, and one block per (group, chunk)
    with chunks the table's capacity over CHUNK."""
    for W in range(1, 10):
        for n_max, page in ((1, 16), (16, 16), (33, 16), (64, 8), (256, 16)):
            per, groups, chunks, smem, _ = tpa.blocking(W, G, D, elem,
                                                        n_max, page)
            assert 1 <= per <= W * G and smem <= tpa.MAX_SMEM
            tasks = [list(range(z * per, min((z + 1) * per, W * G)))
                     for z in range(groups)]
            assert all(tasks)
            assert sorted(i for t in tasks for i in t) == list(range(W * G))
            assert chunks == max(1, math.ceil(n_max * page / tpa.CHUNK))


@pytest.mark.parametrize("n_max,page", [(1, 16), (8, 16), (16, 16),
                                        (17, 16), (64, 8), (100, 32)])
def test_chunk_offsets_are_fixed_multiples(n_max, page):
    """Chunk starts are 0, C, 2C, ... below the capacity, whatever the
    window, group size or head dim: the split depends on the position
    alone, so a row's bits do not depend on the call's shape."""
    starts = tpa.chunk_starts(n_max, page)
    C = tpa.CHUNK
    assert C % TILE == 0
    assert starts == list(range(0, n_max * page, C))
    assert all(s % C == 0 for s in starts)
    assert {tpa.blocking(W, G, D, 2, n_max, page)[2]
            for W in (1, 5, 9) for G in (1, 8) for D in (16, 64)} \
        == {len(starts)}


@pytest.mark.parametrize("W,G,D,elem,n_max", [
    (1, 8, 64, 2, 16), (1, 8, 64, 2, 32), (5, 8, 64, 2, 16),
    (9, 32, 128, 4, 16), (3, 3, 128, 2, 40), (2, 7, 128, 4, 8),
    (4, 4, 12, 2, 10)])
def test_byte_counts_follow_the_kernel_layout(W, G, D, elem, n_max):
    """Shared memory: two ring stages of 64 K rows (D elements rounded up
    to 16 bytes, plus 16 where that count of 16-byte units is even) and 64
    V rows, then 8 warps x 64 f32 probabilities, f32 q and acc rows and
    (m, l) per task.  Partials: f32 (m, l, acc[D]) per task and chunk
    where the table holds more than one chunk."""
    page = 16
    per, groups, chunks, smem, partial = tpa.blocking(W, G, D, elem, n_max,
                                                      page)
    v_row = -(-D * elem // 16) * 16
    k_row = v_row + (16 if (v_row // 16) % 2 == 0 else 0)
    assert smem == 2 * 64 * (k_row + v_row) + 4 * (8 * 64 + 2 * per * D
                                                   + 2 * per)
    assert groups == -(-W * G // per)
    want = 4 * (D + 2) * W * G * chunks if chunks > 1 else 0
    assert partial == want


def split_merge(q, kp, vp, tables, ctx, C, scale=None):
    """What the kernel computes, in plain f32 torch: for each lane and
    query head, an online softmax over 64-token tiles inside each chunk of
    C tokens the context reaches; a context within one chunk is finished
    there, a longer one merged from the chunks' (m, l, acc) in chunk order
    as the online softmax merges tiles.  q (B,H,D); pools (P,page,KV,D);
    tables (B,n_max); ctx (B,)."""
    B, H, D = q.shape
    _, page, KV, _ = kp.shape
    G = H // KV
    cap = tables.shape[1] * page
    scale = scale or D ** -0.5
    out = torch.empty(B, H, D)
    for b in range(B):
        keys = kp[tables[b].long()].reshape(cap, KV, D).float()
        vals = vp[tables[b].long()].reshape(cap, KV, D).float()
        kh = keys.repeat_interleave(G, dim=1)            # (cap, H, D)
        vh = vals.repeat_interleave(G, dim=1)
        n = min(int(ctx[b]), cap)
        parts = []
        for c0 in range(0, max(n, 1), C):
            m = torch.full((H,), -1e30)
            l, acc = torch.zeros(H), torch.zeros(H, D)
            for t0 in range(c0, min(c0 + C, n), TILE):
                t1 = min(t0 + TILE, n)
                s = torch.einsum("hd,thd->ht", q[b].float(), kh[t0:t1])
                s = s * scale
                mx = torch.maximum(m, s.max(dim=1).values)
                p = torch.exp(s - mx[:, None])
                corr = torch.exp(m - mx)
                l = l * corr + p.sum(dim=1)
                acc = acc * corr[:, None] + torch.einsum("ht,thd->hd", p,
                                                         vh[t0:t1])
                m = mx
            parts.append((m, l, acc))
        m, l, acc = parts[0]
        for m_c, l_c, acc_c in parts[1:]:             # in chunk order
            mx = torch.maximum(m, m_c)
            corr, w = torch.exp(m - mx), torch.exp(m_c - mx)
            l = l * corr + l_c * w
            acc = acc * corr[:, None] + acc_c * w[:, None]
            m = mx
        out[b] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def _inputs(seed, B, H, KV, D, page, n_max):
    rng = np.random.default_rng(seed)
    P = B * n_max + 1                                  # +1: the scrap page
    return dict(
        q=rng.normal(size=(B, H, D)).astype(np.float32),
        k_new=rng.normal(size=(B, KV, D)).astype(np.float32),
        v_new=rng.normal(size=(B, KV, D)).astype(np.float32),
        k_pages=rng.normal(size=(P, page, KV, D)).astype(np.float32),
        v_pages=rng.normal(size=(P, page, KV, D)).astype(np.float32),
        tables=rng.permutation(P - 1).reshape(B, n_max).astype(np.int32))


@pytest.mark.parametrize("C", [64, 128, 256])
def test_split_merge_matches_plain_and_pallas(C):
    """Contexts C-1, C, C+1, 2C+1 and the table's capacity (3C), GQA with
    G = 3 (heads not a power of two): the emulated split and merge within
    f32 1e-5 of ``paged_attention_ref`` and of the Pallas
    ``paged_attention`` in interpret mode."""
    B, H, KV, D, page = 5, 6, 2, 16, 16
    n_max = 3 * C // page
    a = _inputs(C, B, H, KV, D, page, n_max)
    ctx = np.asarray([C - 1, C, C + 1, 2 * C + 1, 3 * C], np.int32)
    t = {k: torch.tensor(v) for k, v in a.items()}
    got = split_merge(t["q"], t["k_pages"], t["v_pages"], t["tables"],
                      torch.tensor(ctx), C)
    ref = tpa.paged_attention_ref(t["q"], t["k_pages"], t["v_pages"],
                                  t["tables"], torch.tensor(ctx))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL)
    want = j_paged(jnp.asarray(a["q"]), jnp.asarray(a["k_pages"]),
                   jnp.asarray(a["v_pages"]), jnp.asarray(a["tables"]),
                   jnp.asarray(ctx), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("C", [64, 128, 256])
def test_split_merge_matches_pallas_fused_decode(C):
    """The fused decode step at positions C-2, C-1, C, 2C and capacity-1
    (contexts C-1 .. 3C): the Pallas ``fused_decode_attention`` in
    interpret mode against the emulation on the pools the port's plain
    version wrote (equal to the Pallas kernel's off the scrap page)."""
    B, H, KV, D, page = 5, 8, 2, 16, 16
    n_max = 3 * C // page
    a = _inputs(C + 1, B, H, KV, D, page, n_max)
    pos = np.asarray([C - 2, C - 1, C, 2 * C, 3 * C - 1], np.int32)
    o_j, kj, vj = j_fused(*(jnp.asarray(a[k]) for k in (
        "q", "k_new", "v_new", "k_pages", "v_pages", "tables")),
        jnp.asarray(pos), interpret=True)
    t = {k: torch.tensor(v) for k, v in a.items()}
    o_t, kt, vt = tpa.fused_decode_attention(
        t["q"], t["k_new"], t["v_new"], t["k_pages"], t["v_pages"],
        t["tables"], torch.tensor(pos))
    np.testing.assert_array_equal(kt.numpy()[:-1], np.asarray(kj)[:-1])
    np.testing.assert_array_equal(vt.numpy()[:-1], np.asarray(vj)[:-1])
    got = split_merge(t["q"], kt, vt, t["tables"], torch.tensor(pos) + 1, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(o_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), o_t.numpy(), rtol=0, atol=ATOL)
