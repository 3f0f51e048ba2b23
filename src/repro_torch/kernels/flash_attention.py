"""Flash attention over whole sequences: a CUDA kernel for Hopper and its
plain version.

q (B, S, H, Dk), k (B, S, KV, Dk), v (B, S, KV, Dv) with KV dividing H
(query head h reads kv-head h // (H // KV)); the result is (B, S, H, Dv) in
q's dtype, causal (query i sees keys 0..i) or not.  Dv may differ from Dk,
as MLA's prefill needs.  Scores, softmax and the p·v sums run in f32; on
the card the bf16 kernel multiplies probabilities rounded to bf16 in p·v
(on the tensor cores, as SDPA does), the f32 kernel f32 ones.

``flash_attention`` (kernel: ``csrc/flash_attention.cu``) checks its
arguments, then takes the plain version ``flash_attention_ref`` for
tensors on the CPU and launches the kernel for tensors on a CUDA device;
there is no fallback from one to the other.  Unlike the reference's
Pallas kernel it takes any S >= 1 (its tiles are its own; the ragged edge
is masked), and it takes the head-dim pairs it is built for, the same on
either device: ``HEAD_DIMS``.  ``launches`` counts kernel launches.

Gradients: when grad is enabled and an input requires it,
``flash_attention`` goes through ``FlashAttentionFn``, whose forward also
keeps each row's f32 log-sum-exp and whose backward is
``flash_attention_bwd`` (kernel: ``csrc/flash_attention_bwd.cu``; plain
version ``flash_attention_bwd_ref``), at the head-dim pairs of
``BWD_HEAD_DIMS``.  Otherwise it launches the forward alone, as it always
did, so inference paths are unchanged bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# (Dk, Dv) pairs the kernel is instantiated for: the full-width models'
# (64/64 tinyllama, 96/64 minicpm3's and 192/128 deepseek-v2-lite's MLA
# prefill), 128-wide heads, and the reduced test configs' (16/16 GQA, 24/16
# MLA)
HEAD_DIMS = frozenset({(64, 64), (96, 64), (128, 128), (64, 128), (96, 128),
                       (128, 64), (16, 16), (24, 16), (192, 128)})

# (Dk, Dv) pairs of the backward: the reduced test configs' (16/16 GQA,
# 24/16 MLA), tinyllama's 64/64 and minicpm3's MLA 96/64
BWD_HEAD_DIMS = frozenset({(16, 16), (24, 16), (64, 64), (96, 64)})

# kernel launches (plain versions are not counted); a forward that keeps
# the log-sum-exp for the backward counts as a flash_attention launch
launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None
_bwd_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [p] * 5 + [i] * 8 + [ctypes.c_float, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = i
        _lib = lib
    return _lib


def _bwd_kernels() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("flash_attention_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = (
            [p] * 10 + [i] * 8 + [ctypes.c_float, p])
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_bwd_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_bwd_smem_bytes.restype = i
        _bwd_lib = lib
    return _bwd_lib


def bwd_smem_bytes(Dk: int, Dv: int) -> tuple:
    """The backward's dynamic shared memory per block at (Dk, Dv): (dK/dV
    kernel, dQ kernel); loads (and at first use builds) its library."""
    lib = _bwd_kernels()
    return (lib.flash_attention_bwd_smem_bytes(Dk, Dv, 0),
            lib.flash_attention_bwd_smem_bytes(Dk, Dv, 1))


def smem_bytes(Dk: int, Dv: int) -> int:
    """The bf16 kernel's dynamic shared memory per block at (Dk, Dv); loads
    (and at first use builds) the kernel's library."""
    return _kernels().flash_attention_smem_bytes(Dk, Dv)


def _scores(q, k, causal: bool, scale: float):
    """(B, KV, G, S, S) f32 scaled scores, future keys at -1e30 when
    causal."""
    B, S, H, Dk = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, Dk)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Plain version: f32 scores, a -1e30 causal mask, softmax, f32 p·v
    (the reference's ``kernels/ref.py`` ``flash_attention_ref``, with Dv
    taken from v).  Returns (B, S, H, Dv) in q's dtype."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    w = torch.softmax(_scores(q, k, causal, scale or Dk ** -0.5), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, S, H, Dv).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True, scale=None):
    """Plain version of the log-sum-exp the forward keeps for the backward:
    (B, H, S) f32, each row's logsumexp of its scaled (masked) scores."""
    B, S, H, Dk = q.shape
    s = _scores(q, k, causal, scale or Dk ** -0.5)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            scale=None):
    """Plain backward: P recomputed from ``lse`` (B, H, S) as exp(S * scale
    - lse) (masked scores -1e30, so P = 0), dV = P^T dO, dP = dO V^T,
    delta = rowsum(dO o), dS = P (dP - delta) scale, dQ = dS K, dK = dS^T
    Q, all in f32; dK and dV summed over the G query heads of each
    kv-head.  Returns (dq, dk, dv) in the inputs' dtype."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    scale = scale or Dk ** -0.5
    qf = q.float().reshape(B, S, KV, G, Dk)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, KV, G, Dv)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.float().reshape(B, KV, G, S, 1))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    delta = (dof * o.float().reshape(B, S, KV, G, Dv)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, S, H, Dk)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v) -> None:
    """Validate a call; raises ValueError."""
    named = dict(q=q, k=k, v=v)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported ({_DTYPES})")
    B, S, H, Dk = q.shape
    KV = k.shape[2]
    if (k.shape[:2] != (B, S) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != Dk or KV == 0 or H % KV):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit (need q (B,S,H,Dk), "
                         "k (B,S,KV,Dk), v (B,S,KV,Dv), KV dividing H)")
    if (Dk, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (Dk={Dk}, Dv={v.shape[3]}) not "
                         f"supported ({sorted(HEAD_DIMS)})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    if q.device.type == "cuda":
        for name, t in named.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        if q.dtype == torch.bfloat16:
            _check_tma(q, k, v)


def _check_tma(q, k, v) -> None:
    """What the bf16 kernel's tensor maps (dims (D, heads, S, B), boxes
    of {64, 1, 64, 1}) need: every byte stride a multiple of 16 and below
    2^40, every dim below 2^32, the head dims within three 64-wide
    panels."""
    for name, t in dict(q=q, k=k, v=v).items():
        B, S, heads, D = t.shape
        strides = (2 * D, 2 * heads * D, 2 * S * heads * D)
        if any(s % 16 or s >= 2 ** 40 for s in strides):
            raise ValueError(f"{name}: byte strides {strides} of its tensor "
                             "map must be multiples of 16 below 2^40")
        if max(t.shape) >= 2 ** 32 or D > 192:
            raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit "
                             "a tensor map of 64-wide boxes")


def _check_bwd_dims(Dk: int, Dv: int) -> None:
    if (Dk, Dv) not in BWD_HEAD_DIMS:
        raise ValueError(f"no flash attention backward for head dims "
                         f"(Dk={Dk}, Dv={Dv}) ({sorted(BWD_HEAD_DIMS)})")


def _forward(q, k, v, causal: bool, scale: float, with_lse: bool):
    """One forward launch on the card: (out, lse (B, H, S) f32 or None)."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        err = _kernels().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, S, H, KV, Dk, Dv, int(bool(causal)),
            int(q.dtype == torch.bfloat16), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches["flash_attention"] += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,S,H,Dk); k: (B,S,KV,Dk); v: (B,S,KV,Dv); contiguous, f32 or
    bf16, (Dk, Dv) in ``HEAD_DIMS`` (in ``BWD_HEAD_DIMS`` when a gradient
    is to be taken).  ``scale`` defaults to Dk ** -0.5.  Returns
    (B,S,H,Dv) in q's dtype, differentiable in q, k and v through
    ``FlashAttentionFn`` when grad is enabled and one of them requires
    it."""
    _check(q, k, v)
    scale = float(scale or q.shape[3] ** -0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_bwd_dims(q.shape[3], v.shape[3])
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _forward(q, k, v, causal, scale, with_lse=False)[0]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale=None):
    """The backward of ``flash_attention``: q, k, v, its output o and the
    output's gradient do (same shapes, dtype and device, contiguous), lse
    (B, H, S) f32 from the forward.  (Dk, Dv) in ``BWD_HEAD_DIMS``.  Returns
    (dq, dk, dv) in the inputs' dtype: the plain version
    ``flash_attention_bwd_ref`` on the CPU, the kernel on a CUDA device."""
    _check(q, k, v)
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    _check_bwd_dims(Dk, Dv)
    for name, t in dict(o=o, do=do).items():
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != (B, S, H, Dv)
                or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"of shape {(B, S, H, Dv)} on {q.device}")
    if (not isinstance(lse, torch.Tensor) or tuple(lse.shape) != (B, H, S)
            or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 tensor of shape "
                         f"{(B, H, S)} on {q.device}")
    scale = float(scale or Dk ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       scale=scale)
    if any(t.data_ptr() % 16 for t in (o, do, lse)):
        raise ValueError("o, do and lse must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_kernels().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, KV, Dk, Dv,
            int(bool(causal)), int(q.dtype == torch.bfloat16), scale,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient.  Forward: the kernel, which
    also stores each row's log-sum-exp, on the card; the plain version and
    ``flash_attention_lse_ref`` on the CPU.  It saves q, k, v, the output
    and lse.  Backward: ``flash_attention_bwd`` (the kernel on the card,
    the plain backward on the CPU) on the output's gradient made
    contiguous; (dq, dk, dv) in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            # saved for flash_attention_bwd, which takes contiguous tensors
            o = flash_attention_ref(q, k, v, causal=causal,
                                    scale=scale).contiguous()
            lse = flash_attention_lse_ref(q, k, causal=causal, scale=scale)
        else:
            o, lse = _forward(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None
