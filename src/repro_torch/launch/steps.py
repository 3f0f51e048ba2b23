"""Step-function builders of the full-sequence model (the reference's
``repro.launch.steps``): a prefill step and a one-token serve step.  The
port has no mesh, so they take no sharding context; the training step
waits for the training slice."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model


def make_prefill_step(cfg: ModelConfig):
    """(model, prefill_step(params, batch) -> (logits (B, V), caches))."""
    model = build_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig):
    """(model, serve_step(params, caches, tokens, index) -> (logits (B, V),
    caches)); the caches are written in place."""
    model = build_model(cfg)

    def serve_step(params, caches, tokens, index):
        return model.decode_step(params, caches, tokens, index)

    return model, serve_step
