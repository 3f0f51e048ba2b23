"""Model configuration system.

Every assigned architecture is described by a :class:`ModelConfig`.  A config
is purely declarative: the model builder (`repro.models.model.build_model`)
turns it into init/apply functions.

Layer organisation
------------------
A model is ``prefix_pattern`` (unscanned, heterogeneous head of the network,
e.g. DeepSeek's first dense layer) followed by ``num_units`` repetitions of
``unit_pattern`` executed under ``jax.lax.scan`` (parameters stacked with a
leading ``num_units`` dim so the HLO stays one-unit sized — essential for fast
SPMD compiles of 60+ layer models).

Each pattern element is ``(mixer, ffn)``:
  mixer ∈ {"attn", "mla", "mamba", "mlstm", "slstm"}
  ffn   ∈ {"mlp", "moe", "none"}
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Layer = Tuple[str, str]  # (mixer, ffn)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # Layer layout (see module docstring).
    unit_pattern: Tuple[Layer, ...] = (("attn", "mlp"),)
    prefix_pattern: Tuple[Layer, ...] = ()

    # Attention
    head_dim: int = 0                # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    positional: str = "rope"         # rope | sinusoidal | none

    # MLA (DeepSeek-style multi-head latent attention)
    kv_lora_rank: int = 0            # 0 -> MLA disabled for "mla" mixers
    q_lora_rank: int = 0             # 0 -> direct q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # Mamba (S6)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # xLSTM
    xlstm_num_heads: int = 4

    # Modality frontend stub: "none" | "audio_frames" | "vision_patches"
    frontend: str = "none"
    num_patches: int = 1024          # vision prefix length inside seq budget

    # Numerics / training
    dtype: str = "bfloat16"          # parameter + activation dtype
    norm_eps: float = 1e-5
    optimizer: str = "adamw"         # adamw | adafactor (1T models)
    remat: bool = True

    # Sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded so it shards over 256 (data*model) chips."""
        return _round_up(self.vocab_size, 256)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def num_units(self) -> int:
        body = self.num_layers - len(self.prefix_pattern)
        assert body % len(self.unit_pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by unit of "
            f"{len(self.unit_pattern)}")
        return body // len(self.unit_pattern)

    @property
    def qk_head_dim(self) -> int:
        """Per-head q/k dim (MLA: nope + rope parts)."""
        if self.kv_lora_rank:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6 N D)."""
        n = 0
        n += self.vocab_size * self.d_model          # embed
        n += self.d_model * self.vocab_size          # lm head (untied)
        for mixer, ffn in self.prefix_pattern + self.unit_pattern * self.num_units:
            n += self._mixer_params(mixer) + self._ffn_params(ffn)
            n += 2 * self.d_model                    # two norms
        n += self.d_model                            # final norm
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if not self.num_experts:
            return self.param_count()
        n = self.vocab_size * self.d_model * 2
        for mixer, ffn in self.prefix_pattern + self.unit_pattern * self.num_units:
            n += self._mixer_params(mixer)
            if ffn == "moe":
                per_exp = 3 * self.d_model * self.d_ff_expert
                n += (self.top_k + self.num_shared_experts) * per_exp
                n += self.d_model * self.num_experts   # router
            else:
                n += self._ffn_params(ffn)
            n += 2 * self.d_model
        n += self.d_model
        return n

    def _mixer_params(self, mixer: str) -> int:
        d = self.d_model
        if mixer == "attn":
            hd = self.resolved_head_dim
            return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
        if mixer == "mla":
            qk, v = self.qk_head_dim, self.v_head_dim
            n = 0
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * qk
            else:
                n += d * self.num_heads * qk
            n += d * self.kv_lora_rank + d * self.qk_rope_dim
            n += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + v)
            n += self.num_heads * v * d
            return n
        if mixer == "mamba":
            di, ds = self.mamba_d_inner, self.mamba_d_state
            dt = self.resolved_dt_rank
            return (d * 2 * di + di * self.mamba_d_conv + di
                    + di * (dt + 2 * ds) + dt * di + di
                    + di * ds + di + di * d)
        if mixer == "mlstm":
            H = self.xlstm_num_heads
            dh = d // H
            return 3 * d * H * dh + 2 * d * H + d * d + d * d
        if mixer == "slstm":
            H = self.xlstm_num_heads
            dh = d // H
            return 4 * d * H * dh + 4 * H * dh * dh
        raise ValueError(mixer)

    def _ffn_params(self, ffn: str) -> int:
        d = self.d_model
        if ffn == "mlp":
            return 3 * d * self.d_ff
        if ffn == "moe":
            n = self.d_model * self.num_experts
            n += self.num_experts * 3 * d * self.d_ff_expert
            n += self.num_shared_experts * 3 * d * self.d_ff_expert
            return n
        if ffn == "none":
            return 0
        raise ValueError(ffn)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY = {}


def register(fn):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import arch modules lazily so `register` decorators run
        from repro_torch.configs import archs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    from repro_torch.configs import archs  # noqa: F401
    return sorted(_REGISTRY)
