"""Mamba (S6 selective state space) mixer of the reference's
``repro.models.mamba`` on PyTorch tensors.

Train and prefill run the recurrence s_t = dA_t * s_{t-1} + dBx_t as the
reference's two-level scan (``_blocked_scan``): a scan inside each of 16
blocks of the sequence, a scan of the 16 block aggregates, then each block
shifted by the state entering it.  torch has no ``associative_scan``, so
each level is a log-step (Hillis-Steele) scan of the same combine; it
rounds in another order than XLA's tree.  Decode is the O(1) recurrent
update and writes the conv and ssm caches IN PLACE.  States are float32.

Parameters (the reference's layout, per layer): ``w_in`` (d, 2 di),
``conv_w`` (dc, di), ``conv_b`` (di,), ``w_x`` (di, dt_rank + 2 ds),
``w_dt`` (dt_rank, di) in the model dtype; ``dt_bias`` (di,), ``A_log``
(di, ds), ``D`` (di,) in float32; ``w_out`` (di, d).  Caches: ``conv``
(B, dc-1, di) and ``ssm`` (B, di, ds), float32.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import silu, softplus

# blocks of the scan's first level (1 when S % NBLOCKS or S < 2 NBLOCKS)
NBLOCKS = 16


def _causal_conv(xi, w, b):
    """xi: (B,S,di); w: (dc, di); returns (B,S,di) in xi's dtype: the dc
    shifted products summed in the reference's order, each rounded to the
    activation dtype."""
    dc = w.shape[0]
    S = xi.shape[1]
    xp = torch.nn.functional.pad(xi, (0, 0, dc - 1, 0))
    out = sum(xp[:, j:j + S] * w[j] for j in range(dc))
    return out + b


def _ssm_params(h, p, cfg):
    """h: (B,S,di) post-conv.  Returns dt (B,S,di), B/C (B,S,ds), all f32,
    and A (di,ds) f32."""
    ds, dtr = cfg.mamba_d_state, cfg.resolved_dt_rank
    dbc = h @ p["w_x"]
    dt_low = dbc[..., :dtr]
    Bm = dbc[..., dtr:dtr + ds].float()
    Cm = dbc[..., dtr + ds:].float()
    # the product in the model dtype, then f32 with the f32 bias
    dt = softplus(dt_low @ p["w_dt"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"].float())
    return dt, Bm, Cm, A


def _comb(a, b):
    a1, b1 = a
    a2, b2 = b
    return a2 * a1, a2 * b1 + b2


def _scan(a, b, dim: int):
    """Inclusive scan of ``_comb`` along ``dim`` in log2(n) steps: at step
    d every element combines with the one d before it (Hillis-Steele)."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_prev, b_prev = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        a_cur, b_cur = a.narrow(dim, d, n - d), b.narrow(dim, d, n - d)
        na, nb = _comb((a_prev, b_prev), (a_cur, b_cur))
        a = torch.cat([a.narrow(dim, 0, d), na], dim=dim)
        b = torch.cat([b.narrow(dim, 0, d), nb], dim=dim)
        d *= 2
    return a, b


def _blocked_scan(dA, dBx, nblocks: int = NBLOCKS):
    """dA, dBx: (B,S,di,ds) f32 -> the states (B,S,di,ds): scans inside
    ``nblocks`` blocks of the sequence, a scan of the block aggregates, and
    ``aa * init + bb`` with the exclusive prefix state ``init`` entering
    each block, as the reference's ``_blocked_scan``."""
    B, S, di, ds = dA.shape
    if S % nblocks or S < 2 * nblocks:
        nblocks = 1
    Sl = S // nblocks
    a = dA.reshape(B, nblocks, Sl, di, ds)
    b = dBx.reshape(B, nblocks, Sl, di, ds)
    aa, bb = _scan(a, b, 2)                                  # block-local
    _, pb = _scan(aa[:, :, -1], bb[:, :, -1], 1)             # (B,nb,di,ds)
    init = torch.cat([torch.zeros_like(pb[:, :1]), pb[:, :-1]], dim=1)
    states = aa * init[:, :, None] + bb
    return states.reshape(B, S, di, ds)


def mamba_apply(x, p, cfg, mode, cache=None, index=None):
    """x: (B,S,D) normed.  mode "train" / "prefill": the selective scan
    over S; prefill returns the cache {"conv": the last dc-1 inputs of the
    conv in f32 (zero-padded on the left when S < dc-1), "ssm": the last
    state}.  mode "decode": S == 1; one recurrent step from ``cache``,
    whose tensors are written IN PLACE.  Returns (out (B,S,D), cache or
    None)."""
    B, S, _ = x.shape
    di, dc = cfg.mamba_d_inner, cfg.mamba_d_conv
    xz = x @ p["w_in"]
    xi, z = xz[..., :di], xz[..., di:]

    if mode == "decode":
        window = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)],
                           dim=1)                            # (B,dc,di) f32
        conv = (torch.einsum("bcd,cd->bd", window, p["conv_w"].float())
                [:, None] + p["conv_b"])
        h = silu(conv).to(x.dtype)                           # (B,1,di)
        dt, Bm, Cm, A = _ssm_params(h, p, cfg)
        dA = torch.exp(dt[:, 0, :, None] * A)                # (B,di,ds)
        dBx = (dt[:, 0, :, None] * Bm[:, 0, None, :]
               * h.float()[:, 0, :, None])
        s = dA * cache["ssm"] + dBx
        y = torch.einsum("bds,bs->bd", s, Cm[:, 0])[:, None]  # (B,1,di)
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(s)
        new_cache = cache
    elif mode in ("train", "prefill"):
        h = silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
        dt, Bm, Cm, A = _ssm_params(h, p, cfg)
        dA = torch.exp(dt[..., None] * A)                    # (B,S,di,ds)
        dBx = dt[..., None] * Bm[:, :, None, :] * h.float()[..., None]
        states = _blocked_scan(dA, dBx)
        y = torch.einsum("bsdn,bsn->bsd", states, Cm)
        new_cache = None
        if mode == "prefill":
            conv = (xi[:, S - (dc - 1):] if S >= dc - 1 else
                    torch.nn.functional.pad(xi, (0, 0, dc - 1 - S, 0)))
            # a copy: a view would keep every position's states alive
            new_cache = {"conv": conv.float(), "ssm": states[:, -1].clone()}
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    y = y + p["D"].float() * h.float()
    y = y.to(x.dtype) * silu(z)
    return y @ p["w_out"], new_cache
