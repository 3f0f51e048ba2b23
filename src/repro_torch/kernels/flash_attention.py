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

# kernel launches (plain versions are not counted)
launches: Dict[str, int] = {"flash_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 8 + [ctypes.c_float, p])
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = i
        _lib = lib
    return _lib


def smem_bytes(Dk: int, Dv: int) -> int:
    """The bf16 kernel's dynamic shared memory per block at (Dk, Dv); loads
    (and at first use builds) the kernel's library."""
    return _kernels().flash_attention_smem_bytes(Dk, Dv)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Plain version: f32 scores, a -1e30 causal mask, softmax, f32 p·v
    (the reference's ``kernels/ref.py`` ``flash_attention_ref``, with Dv
    taken from v).  Returns (B, S, H, Dv) in q's dtype."""
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    G = H // KV
    scale = scale or Dk ** -0.5
    qf = q.float().reshape(B, S, KV, G, Dk)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, S, H, Dv).to(q.dtype)


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


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,S,H,Dk); k: (B,S,KV,Dk); v: (B,S,KV,Dv); contiguous, f32 or
    bf16, (Dk, Dv) in ``HEAD_DIMS``.  ``scale`` defaults to Dk ** -0.5.
    Returns (B,S,H,Dv) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    B, S, H, Dk = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _kernels().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, Dk, Dv, int(bool(causal)),
            int(q.dtype == torch.bfloat16), float(scale or Dk ** -0.5),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches["flash_attention"] += 1
    return out
