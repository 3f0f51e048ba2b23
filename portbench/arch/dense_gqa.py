"""The port's model for a dense GQA decoder (``"arch": "dense_gqa"``):
RMSNorm, rope, grouped-query attention and a SwiGLU MLP in every layer,
untied embedding and lm_head, as Mistral's and Llama's ``config.json``
describe them.  Maps the configuration file's published keys onto the
port's ``ModelConfig``; the model itself is the program's."""

from __future__ import annotations

from typing import Dict


def port_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig

    if cfg.get("hidden_act", "silu") != "silu" \
            or cfg.get("tie_word_embeddings", False) \
            or cfg.get("attention_bias", False):
        raise ValueError(f"{cfg['name']}: dense_gqa serves untied SwiGLU "
                         "stacks without attention bias")
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or 0,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=cfg["torch_dtype"], frontend="none", positional="rope")
