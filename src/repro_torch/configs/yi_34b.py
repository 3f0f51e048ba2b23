"""yi-34b [dense] — arXiv:2403.04652; hf-verified.

60L d_model=7168 56H GQA kv=8 d_ff=20480 vocab=64000 (llama arch, GQA).
"""

from repro_torch.configs.base import ModelConfig, register


@register
def yi_34b() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
    )
