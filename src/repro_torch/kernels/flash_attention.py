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
tensors on the CPU (or on ``meta``, where nothing runs: the dry run's
shapes) and launches the kernel for tensors on a CUDA device; there is no
fallback from one to the other.  Under a ``launch.roofline.CostCounter``
the forward and the backward report their analytic FLOPs and bytes
(``kernels.cost``).  Unlike the reference's
Pallas kernel it takes any S >= 1 (its tiles are its own; the ragged edge
is masked), and it takes the head-dim pairs it is built for, the same on
either device: ``HEAD_DIMS``.  ``launches`` counts kernel launches.

Gradients: when grad is enabled and an input requires it,
``flash_attention`` goes through ``FlashAttentionFn``, whose forward also
keeps each row's f32 log-sum-exp and whose backward is
``flash_attention_bwd`` (kernel: ``csrc/flash_attention_bwd.cu``; plain
version ``flash_attention_bwd_ref``), at the head-dim pairs of
``BWD_HEAD_DIMS``.  On the card the bf16 backward runs its products on
the tensor cores with P and dS rounded to bf16 as operands (the plain
version's ``bf16_operands``), the f32 one on f32 FMAs; ``bwd_error`` is
its error as a fraction of the tolerance a test holds it to.  Otherwise
it launches the forward alone, as it always did, so inference paths are
unchanged bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, cost

NEG_INF = -1e30

# (Dk, Dv) pairs the kernel is instantiated for: the full-width models'
# (64/64 tinyllama, 96/64 minicpm3's and 192/128 deepseek-v2-lite's MLA
# prefill), 128-wide heads, and the reduced test configs' (16/16 GQA, 24/16
# MLA)
HEAD_DIMS = frozenset({(64, 64), (96, 64), (128, 128), (64, 128), (96, 128),
                       (128, 64), (16, 16), (24, 16), (192, 128)})

# (Dk, Dv) pairs of the backward: the reduced test configs' (16/16 GQA,
# 24/16 MLA), tinyllama's 64/64, minicpm3's MLA 96/64, 128-wide heads (yi,
# minitron, kimi, jamba, pixtral) and deepseek-v2-lite's MLA 192/128
BWD_HEAD_DIMS = frozenset({(16, 16), (24, 16), (64, 64), (96, 64),
                           (128, 128), (192, 128)})

# the backward kernel's tolerances against the plain backward in f32
# (``bwd_error``).  f32: 2e-5 of the tensor's largest value (at least 1),
# sums of up to 2048 x 8 products in another order (f32 FMAs against
# cuBLAS GEMMs).  bf16, per element, |got - ref| <= 2^-8 |ref| + 2^-6 rss
# + BWD_BF16_ATOL, derived from what the kernel rounds: its output is the
# f32 sum x rounded once to bf16 (at most 2^-8 |x|, an 8-bit significand);
# x - ref is the sum of the terms t_j of the gradient's sum (P dout for dV,
# dS Q for dK, dS K for dQ) times the relative error d_j of rounding their
# P or dS operand to bf16, |d_j| <= 2^-8, mean zero, independent from term
# to term, so its standard deviation is at most 2^-8 rss / sqrt(3) with rss
# = sqrt(sum t_j^2) (``flash_attention_bwd_rss``); 2^-6 rss is 6.9 of them.
# BWD_BF16_ATOL covers the f32 noise (sum orders, exp2 against exp).  The
# worst case sum |t_j| >= |ref| would admit a gradient scaled by 1.01
# everywhere; this bound rejects it where |ref| > 2.6 rss (a few elements
# in a thousand of random-sign sums)
BWD_F32_RTOL = 2e-5
BWD_BF16_ATOL = 1e-4

# kernel launches (plain versions are not counted); a forward that keeps
# the log-sum-exp for the backward counts as a flash_attention launch
launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
cost.LAUNCHES.append(launches)
# devices on which a wrapper runs the plain version (on ``meta`` it computes
# nothing: shapes alone, for the dry run)
PLAIN = ("cpu", "meta")

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
        lib.flash_attention_bwd_smem_bytes.argtypes = [i, i, i, i]
        lib.flash_attention_bwd_smem_bytes.restype = i
        _bwd_lib = lib
    return _bwd_lib


def bwd_smem_bytes(Dk: int, Dv: int, bf16: bool) -> tuple:
    """The backward's dynamic shared memory per block at (Dk, Dv), of its
    bf16 (wgmma) or f32 (FMA) body: (dK/dV kernel, dQ kernel); loads (and
    at first use builds) its library."""
    lib = _bwd_kernels()
    return (lib.flash_attention_bwd_smem_bytes(Dk, Dv, 0, int(bf16)),
            lib.flash_attention_bwd_smem_bytes(Dk, Dv, 1, int(bf16)))


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


def _bwd_operands(q, k, v, o, lse, do, causal: bool, scale):
    """The plain backward's f32 operands: q (B, S, KV, G, Dk), k, dO (B,
    S, KV, G, Dv), and P and dS (B, KV, G, S, S)."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    scale = scale or Dk ** -0.5
    qf = q.float().reshape(B, S, KV, G, Dk)
    dof = do.float().reshape(B, S, KV, G, Dv)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.float().reshape(B, KV, G, S, 1))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    delta = (dof * o.float().reshape(B, S, KV, G, Dv)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    return qf, k.float(), dof, p, ds


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            scale=None, bf16_operands: bool = False):
    """Plain backward: P recomputed from ``lse`` (B, H, S) as exp(S * scale
    - lse) (masked scores -1e30, so P = 0), dV = P^T dO, dP = dO V^T,
    delta = rowsum(dO o), dS = P (dP - delta) scale, dQ = dS K, dK = dS^T
    Q, all in f32; dK and dV summed over the G query heads of each
    kv-head.  ``bf16_operands`` rounds P and dS to bf16 before the three
    gradient products, as the bf16 kernel does.  Returns (dq, dk, dv) in
    the inputs' dtype."""
    B, S, H, Dk = q.shape
    qf, kf, dof, p, ds = _bwd_operands(q, k, v, o, lse, do, causal, scale)
    if bf16_operands:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, S, H, Dk)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_rss(q, k, v, o, lse, do, *, causal: bool = True,
                            scale=None):
    """The root-sum-square of the terms of each gradient's sums, (dq, dk,
    dv)-shaped, f32: sqrt(sum dS^2 K^2), sqrt(sum dS^2 Q^2), sqrt(sum P^2
    dO^2) from the plain backward's operands; the scale of the bf16
    kernel's operand rounding in ``bwd_error``."""
    B, S, H, Dk = q.shape
    qf, kf, dof, p, ds = _bwd_operands(q, k, v, o, lse, do, causal, scale)
    p, ds = p.square(), ds.square()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof.square())
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf.square())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf.square())
    return dq.reshape(B, S, H, Dk).sqrt(), dk.sqrt(), dv.sqrt()


def bwd_error(got, ref, rss=None) -> float:
    """The error of a gradient of the backward kernel against the plain
    backward's in f32, ``ref`` (``flash_attention_bwd_ref`` on f32 inputs),
    as a fraction of its tolerance: at most 1 passes.  f32 (``rss`` None):
    max |got - ref| over BWD_F32_RTOL * max(1, max |ref|).  bf16: the
    largest of |got - ref| / (2^-8 |ref| + 2^-6 rss + BWD_BF16_ATOL) over
    the elements, ``rss`` from ``flash_attention_bwd_rss`` (the derivation
    is beside the constants)."""
    diff = (got.float() - ref.float()).abs()
    if rss is None:
        return diff.max().item() / (BWD_F32_RTOL * max(
            1.0, ref.abs().max().item()))
    return (diff / (2 ** -8 * ref.float().abs() + 2 ** -6 * rss
                    + BWD_BF16_ATOL)).max().item()


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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    if q.device.type == "cuda":
        for name, t in named.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        if q.dtype == torch.bfloat16:
            _check_tma(q, k, v)


def _check_tma(*ts, names=("q", "k", "v")) -> None:
    """What the bf16 kernels' tensor maps (dims (D, heads, S, B), boxes
    of {64, 1, 64 or 32, 1}) need: every byte stride a multiple of 16 and
    below 2^40, every dim below 2^32, the head dims within three 64-wide
    panels."""
    for name, t in zip(names, ts):
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


def _pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def _fwd_cost(q, k, v, *, causal: bool = True, scale=None):
    """(flops, bytes) of a forward (the bound in ``chip_smoke.py``): q.k
    and p.v over the (query, key) pairs; q, k, v read and the output
    written once, and the f32 log-sum-exp when a gradient will be taken."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    flops = 2 * B * H * (Dk + Dv) * _pairs(S, causal)
    nbytes = q.element_size() * B * S * (H * Dk + KV * Dk + KV * Dv
                                         + H * Dv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        nbytes += 4 * B * H * S
    return flops, nbytes


def _bwd_cost(q, k, v, o, lse, do, *, causal: bool = True, scale=None):
    """(flops, bytes) of a backward (the bound in ``chip_smoke.py``): the
    five products, q.k, dS.K and dS^T.Q over Dk, dout.v and P^T.dout over
    Dv; q, k, v, o, dout and lse read, dq, dk and dv written once."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    flops = 2 * B * H * (3 * Dk + 2 * Dv) * _pairs(S, causal)
    nbytes = (q.element_size() * B * S * (2 * H * Dk + 2 * KV * Dk
                                          + 2 * KV * Dv + 2 * H * Dv)
              + 4 * B * H * S)
    return flops, nbytes


@cost.counted("flash_attention", _fwd_cost)
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
    if q.device.type in PLAIN:
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _forward(q, k, v, causal, scale, with_lse=False)[0]


@cost.counted("flash_attention_bwd", _bwd_cost)
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
    if q.device.type in PLAIN:
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       scale=scale)
    if any(t.data_ptr() % 16 for t in (o, do, lse)):
        raise ValueError("o, do and lse must be 16-byte aligned")
    if q.dtype == torch.bfloat16:
        _check_tma(do, names=("do",))
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
        if q.device.type in PLAIN:
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
