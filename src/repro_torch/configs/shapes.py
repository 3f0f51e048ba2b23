"""The four assigned input-shape cells.

``train_*``  lowers ``train_step`` (tokens+labels, full fwd+bwd+optimizer).
``prefill_*`` lowers ``prefill_step`` (full-sequence forward building caches).
``decode_*``/``long_*`` lower ``serve_step`` (ONE new token against a KV cache
/ recurrent state of ``seq_len``), never ``train_step``.

``long_500k`` applies only to sub-quadratic architectures (SSM / hybrid); the
8 pure full-attention archs skip it (recorded in DESIGN.md §5 and in the
roofline table as ``skip(full-attn)``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def get_shape(name: str) -> Shape:
    return SHAPES[name]


def applicable(cfg: ModelConfig, shape: Shape) -> bool:
    """Is this (arch, shape) cell runnable? (assignment skip rules)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False  # pure full-attention arch; noted in DESIGN.md §5
    return True


def all_cells():
    """Yield every (arch_name, shape_name, runnable) triple — 40 cells."""
    from repro_torch.configs.base import list_archs
    for arch in list_archs():
        from repro_torch.configs.base import get_config
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            yield arch, sname, applicable(cfg, shape)
