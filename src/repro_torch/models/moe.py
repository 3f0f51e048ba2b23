"""Mixture-of-Experts of the reference's ``repro.models.moe`` on PyTorch
tensors: the router (softmax, top-k, renormalise), ``moe_dense`` (every
expert computed for every token, gated combine) and ``moe_apply`` (routed
experts plus the shared experts).

The reference's expert-parallel ``moe_ep`` shards experts over a mesh;
the port has no mesh, so ``moe_apply`` takes the dense branch, as the
reference does without one.  The reference computes MoE in jnp einsums,
outside any Pallas kernel; here the expert products are batched matrix
products (``torch.matmul``) over the stored (E, d, F) weights, which are
read in place, never permuted or copied.

Parameters (the reference's layout): ``router`` (d, E); ``w_gate`` /
``w_up`` (E, d, F); ``w_down`` (E, F, d); with shared experts
``shared_gate`` / ``shared_up`` (d, n_shared * F) and ``shared_down``
(n_shared * F, d).
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import silu


def _route(x2, router, top_k: int):
    """x2: (T, d) -> (topv, topi) each (T, k), renormalised.

    The router runs in f32 (exact products of the stored values, f32 sums),
    as the reference's ``preferred_element_type=float32``.  Top-k takes the
    lower expert index first among equal probabilities, as ``lax.top_k``
    does: a stable descending sort, then its first k."""
    logits = x2.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return topv, topi


def moe_dense(x, p, cfg):
    """x: (B, S, d).  Every expert on every token; the k chosen experts'
    outputs combined in f32 with the router's weights, then cast back.

    The combine adds the k weighted outputs one after another in
    elementwise ops, so a token's result does not depend on the other
    tokens of the call.  The reference sums all E gated outputs, the
    unchosen ones with weight 0; the two differ at f32 rounding only."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    T = x2.shape[0]
    topv, topi = _route(x2, p["router"], cfg.top_k)
    xe = x2[None]                                       # (1, T, d)
    g = torch.matmul(xe, p["w_gate"])                   # (E, T, F)
    u = torch.matmul(xe, p["w_up"])
    y_all = torch.matmul(silu(g) * u, p["w_down"])      # (E, T, d)
    tok = torch.arange(T, device=x.device)
    comb = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):
        comb = comb + y_all[topi[:, j], tok].float() * topv[:, j:j + 1]
    return comb.to(x.dtype).reshape(B, S, d)


def moe_apply(x, p, cfg):
    """Full MoE block: routed experts (+ shared experts)."""
    y = moe_dense(x, p, cfg)
    if cfg.num_shared_experts:
        h = silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
        y = y + h @ p["shared_down"]
    return y
