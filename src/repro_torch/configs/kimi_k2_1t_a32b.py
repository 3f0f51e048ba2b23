"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table; unverified).

Built exactly per the assignment line: 61L d_model=7168 64H GQA kv=8
d_ff(expert)=2048 vocab=163840, MoE 384 routed top-8 (+1 shared, DeepSeek-V3
family convention).  All 61 layers MoE.  ~1.03T params, ~32B active.

Dry-run trains with Adafactor (factored second moment, no fp32 master):
AdamW at >=12 bytes/param cannot fit 1T params on 256x16GB chips; see
EXPERIMENTS.md §Dry-run.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab_size=163840,
        unit_pattern=(("attn", "moe"),),
        num_experts=384,
        num_shared_experts=1,
        top_k=8,
        d_ff_expert=2048,
        optimizer="adafactor",
    )
