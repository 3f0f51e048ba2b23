"""The yardstick's arithmetic: the card's peaks and the analytic FLOPs and
bytes of the work the program does.

Frozen copies of the counting rules of ``src/repro_torch/launch/roofline.py``
(``PEAK_FLOPS``, ``HBM_BW``; ``model_flops``: 2 x the matmul parameters
per token computed) and ``src/repro_torch/kernels/paged_attention.py``
(``_attend_cost`` / ``_decode_cost``: q.k and p.v at 2 x D operations per
(row, key) pair and head; the K/V of the context read once, the query and
output rows once, the new K/V row read and written once), computed here
from the configuration file's published keys, so a change to the
program's counters moves nothing the benchmark reports.

Peaks: NVIDIA H100 SXM data sheet, dense, without sparsity.
"""

from __future__ import annotations

from typing import Dict, Iterable

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the counts need, from a configuration file's keys."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return dict(d=d, H=H, KV=cfg["num_key_value_heads"],
                Dh=cfg.get("head_dim") or d // H,
                F=cfg["intermediate_size"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"], e=2)


def matmul_params(cfg: Dict, head: bool = True) -> int:
    """Weights that multiply every token: q, k, v, o and the SwiGLU MLP per
    layer, plus the lm_head (``head``); the embedding is a gather."""
    k = dims(cfg)
    d, H, KV, Dh = k["d"], k["H"], k["KV"], k["Dh"]
    layer = d * H * Dh * 2 + d * KV * Dh * 2 + 3 * d * k["F"]
    return k["L"] * layer + (d * k["V"] if head else 0)


def attention_flops(cfg: Dict, pairs: int) -> float:
    """q.k and p.v over ``pairs`` (query, key) pairs, every layer."""
    k = dims(cfg)
    return 4.0 * k["H"] * k["Dh"] * pairs * k["L"]


def decode_flops(cfg: Dict, ctxs: Iterable[int]) -> float:
    """Model FLOPs of one decode forward over its live lanes: each lane's
    token through every matmul and the lm_head, and attention over its
    context (``ctx`` tokens before it, plus itself)."""
    ctxs = list(ctxs)
    return (2.0 * matmul_params(cfg) * len(ctxs)
            + attention_flops(cfg, sum(c + 1 for c in ctxs)))


def prefill_flops(cfg: Dict, chunks: Iterable) -> float:
    """Model FLOPs of prefill calls: ``chunks`` of (start, n) prompt
    tokens; every token through every matmul (no lm_head: prefill computes
    no logits) and attention over the tokens at or before it."""
    total = 0.0
    for start, n in chunks:
        pairs = n * start + n * (n + 1) // 2
        total += 2.0 * matmul_params(cfg, head=False) * n \
            + attention_flops(cfg, pairs)
    return total


def decode_attention_bytes(cfg: Dict, ctxs: Iterable[int]) -> float:
    """Bytes one layer's ``fused_decode_attention`` launch must move for
    its live lanes: each lane's K/V context read once, its query read and
    output written once, its new K/V row read and written once."""
    k = dims(cfg)
    KV, Dh, H, e = k["KV"], k["Dh"], k["H"], k["e"]
    total = 0.0
    for c in ctxs:
        total += 2 * c * KV * Dh * e + 2 * H * Dh * e + 4 * KV * Dh * e
    return total
