"""musicgen-medium [audio] — arXiv:2306.05284; hf-verified.

48L d_model=1536 24H MHA (kv=24) d_ff=6144 vocab=2048 — decoder-only over
EnCodec tokens.  The EnCodec frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model);
targets are codebook-0 token ids.  Sinusoidal positions (as in MusicGen).
"""

from repro_torch.configs.base import ModelConfig, register


@register
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        positional="sinusoidal",
        frontend="audio_frames",
    )
