"""Step-function builders of the full-sequence model (the reference's
``repro.launch.steps``): a training step (``Model.loss``, its gradient by
autograd, an optimizer update), a prefill step and a one-token serve step.
Each takes the model's context (``launch.sharding.make_ctx``; None for
none), as the reference's do; the port places no sharding constraint, so
the reference's ``grad_shardings`` has no counterpart."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import tree_map
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import get_optimizer


def value_and_grad(fn, params, *args):
    """(fn(params, *args), its gradient in ``params``), as
    ``jax.value_and_grad``: the value detached, the gradient a tree like
    ``params`` in their dtypes (zeros for leaves the value does not use).
    ``params`` are not modified; fn sees detached copies that share their
    storage and require grad."""
    leaves = []

    def leaf(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    p = tree_map(leaf, params)
    with torch.enable_grad():
        value = fn(p, *args)
    grads = iter(
        torch.zeros_like(t) if g is None else g
        for t, g in zip(leaves, torch.autograd.grad(value, leaves,
                                                     allow_unused=True)))
    return value.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, ctx=None, lr: float = 1e-4):
    """(model, opt, train_step(params, opt_state, batch) -> (params,
    opt_state, loss)): one ``Model.loss`` gradient and one update of the
    config's optimizer (``get_optimizer``); the update is functional, so
    the params passed in are left as they were."""
    model = build_model(cfg, ctx)
    opt = get_optimizer(cfg, lr)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model.loss, params, batch)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, loss

    return model, opt, train_step


def make_prefill_step(cfg: ModelConfig, ctx=None):
    """(model, prefill_step(params, batch) -> (logits (B, V), caches))."""
    model = build_model(cfg, ctx)

    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, ctx=None):
    """(model, serve_step(params, caches, tokens, index) -> (logits (B, V),
    caches)); the caches are written in place."""
    model = build_model(cfg, ctx)

    def serve_step(params, caches, tokens, index):
        return model.decode_step(params, caches, tokens, index)

    return model, serve_step
