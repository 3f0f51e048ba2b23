"""minicpm3-4b [dense] — hf:openbmb/MiniCPM3-4B; hf-verified.  MLA.

62L d_model=2560 40H d_ff=6400 vocab=73448 (padded to 73728 for sharding),
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def minicpm3_4b() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        unit_pattern=(("mla", "mlp"),),
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
    )
