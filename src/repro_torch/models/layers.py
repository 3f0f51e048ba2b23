"""Shared building blocks of the model: RMS norm, rotary positions, SwiGLU
MLP, LM loss.  Norm variance, rope angles and the loss run in float32
regardless of the activation dtype, as in the reference
(``repro.models.layers``)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """Rope inverse frequencies, made in float64 with numpy and rounded to
    float32, as the reference does with 64-bit mode off.  Cached per device:
    a fresh host-to-device copy in every layer would make the host wait for
    the device each time.  Callers must not modify the tensor."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.as_tensor(inv.astype(np.float32), device=device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: int tensor (...,) -> cos/sin tables (..., head_dim//2)."""
    inv = _inv_freq(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, Dh); cos/sin: (S, Dh/2) or (B, S, Dh/2)."""
    half = x.shape[-1] // 2
    if cos.ndim == 2:        # (S, half) -> (1, S, 1, half)
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                    # (B, S, half) -> (B, S, 1, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    xf = x.float()
    x1f, x2f = xf[..., :half], xf[..., half:]
    out = torch.cat([x1f * cos - x2f * sin, x1f * sin + x2f * cos], dim=-1)
    return out.to(x.dtype)


def mlp(x, p):
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def lm_loss(h, w_head, labels, mask, vocab_size: int):
    """h: (B, S, D), w_head: (D, Vp), labels: (B, S) int, mask: (B, S).

    Mean NLL over masked-in tokens.  The logits are f32: exact products of
    the stored values with f32 sums, as the reference's
    ``preferred_element_type=float32``.  Padded vocab columns are excluded
    by a -1e9 bias."""
    logits = h.float() @ w_head.float()
    vp = w_head.shape[-1]
    if vp > vocab_size:
        col = torch.arange(vp, device=logits.device)
        logits = logits + torch.where(col < vocab_size, 0.0, -1e9)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
