"""xLSTM mixers of the reference's ``repro.models.xlstm`` on PyTorch
tensors: mLSTM (matrix memory; the stabilised parallel form, chunked, for
train and prefill, the O(1) recurrence for decode) and sLSTM (scalar
memory with exponential gating; strictly sequential, a Python loop over
the sequence in place of ``lax.scan``).  Gates and states are float32.
Decode writes the caches IN PLACE.

mLSTM parallel form (the xLSTM paper's stabilised formulation):
  D_ij = a_i - a_j + log i_j   (j <= i),  a = cumsum(logsigmoid(f))
  h_i  = sum_j (q.k/sqrt(d)) exp(D_ij - m_i) v_j / max(|den_i|, exp(-m_i))
accumulated over key chunks with an online max.

Parameters (per layer, model dtype): mLSTM ``w_q`` / ``w_k`` / ``w_v``
(d, H, dh), ``w_i`` / ``w_f`` (d, H), ``w_og`` / ``w_down`` (d, d); sLSTM
``w_z`` / ``w_i`` / ``w_f`` / ``w_o`` (d, H, dh) and ``r_z`` / ``r_i`` /
``r_f`` / ``r_o`` (H, dh, dh).  Caches (float32): mLSTM ``C`` (B, H, dh,
dh), ``n`` (B, H, dh), ``m`` (B, H); sLSTM ``c``, ``n``, ``h``, ``m``
(B, H, dh) each.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import softplus

NEG = -1e30
# the key chunk of the parallel form: the reference's AxisCtx.attn_chunk
ATTN_CHUNK = 1024


def _qkv(x, p, H, dh):
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"]).float()
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"]).float() * dh ** -0.5
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"]).float()
    logi = (x @ p["w_i"]).float()                              # (B,S,H)
    logf = -softplus(-(x @ p["w_f"]).float())      # JAX's log_sigmoid
    return q, k, v, logi, logf


def _mlstm_parallel(q, k, v, logi, logf, chunk: int = ATTN_CHUNK):
    """The stabilised quadratic form, accumulated over key chunks of
    ``chunk`` (S itself when it does not divide S) with an online max.
    q/k/v: (B,S,H,dh) f32; logi/logf: (B,S,H) f32.  Returns (h (B,S,H,dh),
    a = cumsum(logf) (B,S,H), m (B,S,H))."""
    B, S, H, dh = q.shape
    a = torch.cumsum(logf, dim=1)                              # (B,S,H)
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, S, H), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, dh), dtype=torch.float32, device=q.device)
    for p0 in range(0, S, chunk):
        k_i, v_i = k[:, p0:p0 + chunk], v[:, p0:p0 + chunk]
        a_i, i_i = a[:, p0:p0 + chunk], logi[:, p0:p0 + chunk]
        # log-gate matrix for this key chunk: (B, S, H, chunk)
        logD = (a[:, :, None, :] - a_i[:, None, :, :]
                + i_i[:, None, :, :]).permute(0, 1, 3, 2)
        mask = q_pos[:, None] >= (p0 + torch.arange(chunk,
                                                    device=q.device))[None, :]
        logD = logD.masked_fill(~mask[None, :, None, :], NEG)
        # amax, as jnp.max: ties share the gradient equally
        m_new = torch.maximum(m, torch.amax(logD, dim=-1))
        gate = torch.exp(logD - m_new[..., None])
        qk = torch.einsum("bqhd,bchd->bqhc", q, k_i)
        s = qk * gate
        corr = torch.exp(m - m_new)
        l = l * corr + s.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhc,bchd->bqhd", s, v_i)
        m = m_new
    den = torch.maximum(l.abs(), torch.exp(-m)) + 1e-12
    return acc / den[..., None], a, m


def _mlstm_final_state(k, v, logi, a, m_last):
    """State (C, n) equivalent to having run the recurrence to step S."""
    a_last = a[:, -1:, :]                                      # (B,1,H)
    w = torch.exp(a_last - a + logi - m_last[:, None, :])      # (B,S,H)
    wk = w[..., None] * k
    C = torch.einsum("bshk,bshv->bhkv", wk, v)
    n = wk.sum(dim=1)
    return C, n


def mlstm_apply(x, p, cfg, mode, cache=None, index=None):
    """x: (B,S,D) normed.  mode "train" / "prefill": the parallel form;
    prefill returns the cache {"C", "n", "m"} of the recurrence after step
    S.  mode "decode": S == 1; one recurrent step from ``cache``, whose
    tensors are written IN PLACE.  Returns (out (B,S,D), cache or None)."""
    B, S, D = x.shape
    H = cfg.xlstm_num_heads
    dh = D // H
    q, k, v, logi, logf = _qkv(x, p, H, dh)

    if mode == "decode":
        C, n, m = cache["C"], cache["n"], cache["m"]           # f32
        lf, li = logf[:, 0], logi[:, 0]                        # (B,H)
        m_new = torch.maximum(lf + m, li)
        f_ = torch.exp(lf + m - m_new)[..., None]
        i_ = torch.exp(li - m_new)[..., None]
        C_new = f_[..., None] * C + i_[..., None] * torch.einsum(
            "bhk,bhv->bhkv", k[:, 0], v[:, 0])
        n_new = f_ * n + i_ * k[:, 0]
        num = torch.einsum("bhk,bhkv->bhv", q[:, 0], C_new)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", q[:, 0], n_new).abs(),
                            torch.exp(-m_new))[..., None] + 1e-12
        h = (num / den)[:, None]                               # (B,1,H,dh)
        C.copy_(C_new)
        n.copy_(n_new)
        m.copy_(m_new)
        new_cache = cache
    elif mode in ("train", "prefill"):
        h, a, m = _mlstm_parallel(q, k, v, logi, logf)
        new_cache = None
        if mode == "prefill":
            m_last = m[:, -1, :]
            C, n = _mlstm_final_state(k, v, logi, a, m_last)
            new_cache = {"C": C, "n": n, "m": m_last}
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")

    merged = h.reshape(B, -1, D).to(x.dtype)
    og = torch.sigmoid(x @ p["w_og"])
    return (og * merged) @ p["w_down"], new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def _slstm_step(r, carry, pre_in):
    """One step in the (H, B, dh) layout.  r: (H, dh, 4 dh) f32, the
    recurrent weights r_z | r_i | r_f | r_o side by side (f32, as JAX's
    einsum promotes them against the f32 state); carry (c, n, h, m) (H, B,
    dh) f32; pre_in (H, B, 4 dh) f32, the step's input projections z | i |
    f | o.  One product for the four gates: each column is the reference's
    einsum of h with its gate's r."""
    c, n, h, m = carry
    dh = h.shape[-1]
    pre = pre_in + torch.bmm(h, r)
    z_t = torch.tanh(pre[..., :dh])
    i_t = pre[..., dh:2 * dh]
    f_t = pre[..., 2 * dh:3 * dh]
    o_t = torch.sigmoid(pre[..., 3 * dh:])
    fm = f_t + m
    m_new = torch.maximum(fm, i_t)
    i_ = torch.exp(i_t - m_new)
    f_ = torch.exp(fm - m_new)
    c_new = f_ * c + i_ * z_t
    n_new = f_ * n + i_
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_apply(x, p, cfg, mode, cache=None, index=None):
    """x: (B,S,D) normed.  mode "train" / "prefill": the recurrence over S
    from a zero state (m included); prefill returns the cache {"c", "n",
    "h", "m"} after step S.  mode "decode": S == 1; one step from
    ``cache``, whose tensors are written IN PLACE.  Returns (out (B,S,D),
    cache or None); the mixer has no output projection."""
    B, S, D = x.shape
    H = cfg.xlstm_num_heads
    dh = D // H
    gates = torch.cat([torch.einsum("bsd,dhk->bshk", x, p[w])
                       for w in ("w_z", "w_i", "w_f", "w_o")], dim=-1).float()
    r = torch.cat([p[w] for w in ("r_z", "r_i", "r_f", "r_o")],
                  dim=-1).float()                          # (H, dh, 4 dh)
    names = ("c", "n", "h", "m")

    if mode == "decode":
        carry = tuple(cache[k].transpose(0, 1) for k in names)
        new = _slstm_step(r, carry, gates[:, 0].transpose(0, 1))
        for t, v in zip(carry, new):
            t.copy_(v)                   # through the views into the cache
        out = cache["h"][:, None]                              # (B,1,H,dh)
        new_cache = cache
    elif mode in ("train", "prefill"):
        pre = gates.permute(1, 2, 0, 3).contiguous()           # (S,H,B,4dh)
        if x.device.type == "meta":
            # nothing runs on meta (the dry run's count): the S steps as
            # one step over S*B lanes, the loop's ops and FLOPs summed,
            # each step's incoming state stood in for by its inputs
            pre_all = pre.transpose(0, 1).reshape(H, S * B, 4 * dh)
            new = _slstm_step(r, (pre_all[..., :dh],) * 4, pre_all)
            out = new[2].reshape(H, S, B, dh).permute(2, 1, 0, 3)
            carry = tuple(t.reshape(H, S, B, dh)[:, -1] for t in new)
        else:
            z0 = torch.zeros((H, B, dh), dtype=torch.float32,
                             device=x.device)
            carry = (z0, z0, z0, z0)
            hs = []
            for t in range(S):
                carry = _slstm_step(r, carry, pre[t])
                hs.append(carry[2])
            out = torch.stack(hs, dim=0).permute(2, 0, 1, 3)   # (B,S,H,dh)
        new_cache = None
        if mode == "prefill":
            new_cache = {k: t.transpose(0, 1).contiguous()
                         for k, t in zip(names, carry)}
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")

    merged = out.reshape(B, -1, D).to(x.dtype)
    return merged, new_cache
