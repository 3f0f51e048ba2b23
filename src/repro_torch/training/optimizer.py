"""Optimizers on trees of tensors (the reference's
``repro.training.optimizer``).

``adamw``     — params in their dtype with f32 first/second moments.
``adafactor`` — factored second moment over the last two dims, no momentum,
                no fp32 master copy (the 1T-param kimi-k2 config's).

A tree is nested dicts, tuples and lists with tensors at the leaves (the
model's parameter layout).  ``update(params, grads, state)`` is functional,
as the reference's contract is: it returns new parameter and state trees
and leaves its arguments unchanged, so a caller may keep the tensors it
passed (a restart from the initial parameters reuses them).  Every
intermediate is f32, as in the reference; the bias corrections ``1 - b**t``
are taken in f32 from the step count, as ``jnp`` takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.convert import (Leaves, tree_leaves, tree_map,
                                        tree_unzip)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (params, grads, state) -> (p, s)


def _zeros(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    """The int32 step counter, 0, on the parameters' device."""
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else "cpu")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros, params),
                "v": tree_map(_zeros, params), "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1
        t = step.to(torch.float32)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return Leaves(((p.float() - lr * u).to(p.dtype), m, v))

        out = tree_map(upd, params, grads, state["m"], state["v"])
        new_p, new_m, new_v = tree_unzip(out, 3)
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (simplified: beta1=0, factored v for ndim>=2)
# ---------------------------------------------------------------------------
def adafactor(lr: float = 1e-4, decay: float = 0.99, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    def _factored(p):
        return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def leaf(p):
            if _factored(p):
                return {"vr": _zeros(p, p.shape[:-1]),
                        "vc": _zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros(p)}
        return {"stats": tree_map(leaf, params), "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"] + 1

        def upd(p, g, s):
            g = g.float()
            g2 = torch.square(g) + eps
            if _factored(p):
                vr = decay * s["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * s["vc"] + (1 - decay) * g2.mean(dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                    + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                new_s = {"vr": vr, "vc": vc}
            else:
                v = decay * s["v"] + (1 - decay) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            rms = torch.sqrt(torch.square(u).mean() + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return Leaves(((p.float() - lr * u).to(p.dtype), new_s))

        # the stats tree mirrors the parameters', so at each parameter
        # tree_map hands over that parameter's stat dict
        out = tree_map(upd, params, grads, state["stats"])
        new_p, new_s = tree_unzip(out, 2)
        return new_p, {"stats": new_s, "step": step}

    return Optimizer("adafactor", init, update)


def get_optimizer(cfg, lr: float = 1e-4) -> Optimizer:
    return adafactor(lr) if cfg.optimizer == "adafactor" else adamw(lr)
