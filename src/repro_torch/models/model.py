"""The paged-serving subset of the reference's model API
(``repro.models.model``), on PyTorch tensors.

Parameters are a plain dict of tensors in the reference's layout:
``embed`` (V, d); ``prefix`` {"l{i}": layer}; ``units`` {"l{i}": layer},
every leaf stacked on a leading ``num_units`` dim; ``final_norm`` (d,);
``lm_head`` (d, V_padded).  An attention layer holds ln1, wq (d, H, Dh),
wk/wv (d, KV, Dh), wo (H, Dh, d), ln2, w_gate/w_up (d, d_ff), w_down
(d_ff, d).  With the same layout, weights carried over from the JAX
package (``convert.params_from_numpy``) compute the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import stack_apply_paged


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # (lm_head, its version counter, its f32 copy); see _head_f32
    _head: Any = dataclasses.field(default=None, repr=False, compare=False)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights (normal, std 0.02; norms ones) on the generator's
        device, in the model dtype."""
        cfg = self.cfg
        dt, dev = _dtype(cfg), generator.device

        def dense(*shape):
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (w * 0.02).to(dt)

        def layer(mixer, ffn, stack=0):
            if mixer != "attn" or ffn not in ("mlp", "none"):
                raise ValueError(f"paged model supports attn+mlp layers, "
                                 f"got {(mixer, ffn)}")
            lead = (stack,) if stack else ()
            d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)
            p = {"ln1": torch.ones(lead + (d,), dtype=dt, device=dev),
                 "wq": dense(*lead, d, H, hd), "wk": dense(*lead, d, KV, hd),
                 "wv": dense(*lead, d, KV, hd), "wo": dense(*lead, H, hd, d)}
            if ffn == "mlp":
                p.update(ln2=torch.ones(lead + (d,), dtype=dt, device=dev),
                         w_gate=dense(*lead, d, cfg.d_ff),
                         w_up=dense(*lead, d, cfg.d_ff),
                         w_down=dense(*lead, cfg.d_ff, d))
            return p

        return {
            "embed": dense(cfg.vocab_size, cfg.d_model),
            "prefix": {f"l{i}": layer(m, f)
                       for i, (m, f) in enumerate(cfg.prefix_pattern)},
            "units": {f"l{i}": layer(m, f, stack=cfg.num_units)
                      for i, (m, f) in enumerate(cfg.unit_pattern)},
            "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "lm_head": dense(cfg.d_model, cfg.vocab_padded),
        }

    # ------------------------------------------------------------------
    def supports_paged(self) -> bool:
        """Paged serving covers pure-attention stacks with rope or no
        positional encoding and no modality frontend."""
        cfg = self.cfg
        return (all(m == "attn" for m, _ in
                    cfg.prefix_pattern + cfg.unit_pattern)
                and cfg.positional in ("rope", "none")
                and cfg.frontend == "none")

    def paged_cache_specs(self, num_pages: int, page: int):
        """Page pools per attention layer as ``meta`` tensors: k/v
        (num_pages, page, KV, Dh); unit pools carry the leading num_units
        dim."""
        cfg = self.cfg
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        dt = _dtype(cfg)

        def kv(*lead):
            shape = lead + (num_pages, page, KV, hd)
            return {"k": torch.empty(shape, dtype=dt, device="meta"),
                    "v": torch.empty(shape, dtype=dt, device="meta")}

        return {"prefix": tuple(kv() for _ in cfg.prefix_pattern),
                "units": {f"l{i}": kv(cfg.num_units)
                          for i in range(len(cfg.unit_pattern))}}

    def init_paged_caches(self, num_pages: int, page: int, device):
        specs = self.paged_cache_specs(num_pages, page)

        def zeros(pool):
            return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
                    for name, s in pool.items()}

        return {"prefix": tuple(zeros(p) for p in specs["prefix"]),
                "units": {k: zeros(p) for k, p in specs["units"].items()}}

    def kv_bytes_per_token(self) -> int:
        """True per-token KV footprint of this model's paged cache."""
        cfg = self.cfg
        n_attn = len(cfg.prefix_pattern) \
            + cfg.num_units * len(cfg.unit_pattern)
        itemsize = torch.empty((), dtype=_dtype(cfg)).element_size()
        return int(2 * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
                   * n_attn)

    def prefill_paged(self, params, pages, tokens, start: int, block_table,
                      n: int):
        """Append one prompt chunk's KV for a single sequence.

        tokens: (1, C) with rows past ``n`` as padding; start: tokens
        already resident.  No logits: the first decode step re-runs the
        final prompt token.  Writes the pools in place and returns them."""
        x = params["embed"][tokens.long()]
        _, pages = stack_apply_paged(x, params, self.cfg, "prefill", pages,
                                     block_table, start, n)
        return pages

    def _head_f32(self, head: torch.Tensor) -> torch.Tensor:
        """f32 copy of the lm_head, made once per head tensor (and again
        after an in-place change to it) instead of in every forward."""
        if (self._head is None or self._head[0] is not head
                or self._head[1] != head._version):
            self._head = (head, head._version, head.float())
        return self._head[2]

    def decode_paged(self, params, pages, tokens, positions, block_tables,
                     *, fused: bool = False):
        """One batched decode step: tokens (B, 1) int32 at per-sequence
        write positions (B,) int32; block_tables (B, n_max) int32.  Returns
        (logits (B, V) f32, pages), the pools written in place.  The
        lm_head product runs in f32 (exact products of the stored values,
        f32 sums), as the reference's ``preferred_element_type=float32``."""
        x = params["embed"][tokens.long()]
        x, pages = stack_apply_paged(x, params, self.cfg, "decode", pages,
                                     block_tables, positions, fused=fused)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = x[:, 0].float() @ self._head_f32(params["lm_head"])
        return logits[:, :self.cfg.vocab_size], pages


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
