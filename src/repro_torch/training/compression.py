"""Gradient compression with error feedback (the reference's
``repro.training.compression``).

int8 per-tensor symmetric quantization; the quantization error is carried in
an error-feedback buffer and re-added the next step, so the compressed
optimizer trajectory tracks the exact one (standard EF-SGD result).
``torch.round`` rounds half to even, as ``jnp.round`` does."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.convert import Leaves, tree_map, tree_unzip


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@torch.no_grad()
def compress_grads(grads, ef):
    """Returns (decompressed grads as seen post-allreduce, new ef)."""
    def leaf(g, e):
        gf = g.float() + e
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s)
        return Leaves((deq.to(g.dtype), gf - deq))

    return tree_unzip(tree_map(leaf, grads, ef), 2)


def compressed_bytes_ratio(dtype=torch.bfloat16) -> float:
    return (torch.empty((), dtype=torch.int8).element_size()
            / torch.empty((), dtype=dtype).element_size())
