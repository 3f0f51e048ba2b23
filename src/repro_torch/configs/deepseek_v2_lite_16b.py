"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434; hf-verified.

27L d_model=2048 16H d_ff_expert=1408 vocab=102400, MoE 64 routed top-6 +
2 shared, MLA kv_lora=512.  Per the HF config the first layer is dense
(``first_k_dense_replace=1``) with d_ff=10944.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_v2_lite_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,                    # dense first layer
        vocab_size=102400,
        prefix_pattern=(("mla", "mlp"),),
        unit_pattern=(("mla", "moe"),),
        kv_lora_rank=512,
        q_lora_rank=0,                 # lite: direct q projection
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
    )
