"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887; hf-verified.

32L d_model=4096 32H GQA kv=8 d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave (attention at layer 4 of each 8-layer unit),
MoE every other layer.  Mamba: d_state=16, d_conv=4, expand=2.
Hybrid -> runs ``long_500k`` (only 4 attention layers keep a 500k KV cache,
sharded over the model axis; Mamba layers carry O(1) state).
"""

from repro_torch.configs.base import ModelConfig, register


@register
def jamba_v0p1_52b() -> ModelConfig:
    unit = (
        ("mamba", "mlp"),
        ("mamba", "moe"),
        ("mamba", "mlp"),
        ("mamba", "moe"),
        ("attn", "mlp"),
        ("mamba", "moe"),
        ("mamba", "mlp"),
        ("mamba", "moe"),
    )
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        unit_pattern=unit,
        num_experts=16,
        num_shared_experts=0,
        top_k=2,
        d_ff_expert=14336,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        positional="none",          # Jamba uses no positional encoding
        subquadratic=True,
    )
