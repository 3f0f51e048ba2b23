"""Import the architecture modules the port serves so their ``@register``
decorators run, plus the reduced-config factory for CPU tests."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import tinyllama_1p1b  # noqa: F401
from repro_torch.configs.base import ModelConfig, get_config


def reduced_config(name: str) -> ModelConfig:
    """A tiny same-family variant of an assigned arch for CPU smoke tests.

    Keeps: layer-pattern family (MLA vs GQA vs mamba vs xLSTM, MoE-ness,
    frontend stub, positional scheme).  Shrinks: width, layer count, expert
    count, vocab.  Runs one forward/train step on a single CPU device.
    """
    cfg = get_config(name)
    pat = cfg.unit_pattern
    # keep one full unit (preserves the interleave pattern, e.g. jamba's 8)
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=len(cfg.prefix_pattern) + len(pat),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        remat=False,
    )
    if cfg.num_experts:
        changes.update(num_experts=4, top_k=2,
                       num_shared_experts=min(cfg.num_shared_experts, 1),
                       d_ff_expert=64)
    if cfg.kv_lora_rank:
        changes.update(kv_lora_rank=32,
                       q_lora_rank=48 if cfg.q_lora_rank else 0,
                       qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if any(m == "mamba" for m, _ in pat):
        changes.update(mamba_d_state=8, mamba_d_conv=4, mamba_expand=2)
    if any(m in ("mlstm", "slstm") for m, _ in pat):
        changes.update(xlstm_num_heads=2)
    if cfg.frontend == "vision_patches":
        changes.update(num_patches=8)
    return dataclasses.replace(cfg, **changes)
