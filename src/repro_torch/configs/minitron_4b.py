"""minitron-4b [dense] — arXiv:2407.14679; hf-verified (pruned Nemotron).

32L d_model=3072 24H GQA kv=8 d_ff=9216 vocab=256000, head_dim=128.
The 256k vocabulary stresses the vocab-sharded cross-entropy (loss is chunked
over the sequence to bound the logits' live footprint).
"""

from repro_torch.configs.base import ModelConfig, register


@register
def minitron_4b() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
    )
