"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409 (unverified tier).

Backbone only (mistral-nemo style): 40L d_model=5120 32H GQA kv=8 head_dim=128
d_ff=14336 vocab=131072.  The Pixtral-ViT frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings
(B, num_patches=1024, d_model) that are prepended to the text tokens inside
the sequence budget; loss is computed on the text positions only.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def pixtral_12b() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        frontend="vision_patches",
        num_patches=1024,
    )
