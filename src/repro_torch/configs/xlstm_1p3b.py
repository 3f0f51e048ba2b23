"""xlstm-1.3b [ssm] — arXiv:2405.04517 (unverified).

48L d_model=2048 4 heads vocab=50304, d_ff=0 (xLSTM blocks carry their own
projections).  xLSTM[7:1]: every 8th block is an sLSTM (scalar-memory,
strictly sequential recurrence), the rest mLSTM (matrix-memory, chunkwise-
parallel).  O(1) decode state -> runs ``long_500k``.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def xlstm_1p3b() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        unit_pattern=(("mlstm", "none"),) * 7 + (("slstm", "none"),),
        xlstm_num_heads=4,
        positional="none",
        subquadratic=True,
    )
