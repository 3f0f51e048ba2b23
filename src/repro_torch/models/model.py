"""The reference's model API (``repro.models.model``) on PyTorch tensors,
for "attn" (GQA) and "mla" stacks with "mlp", "moe" or "none" FFNs: the
training loss (``loss``), the full-sequence forward (``logits``,
``prefill``, ``decode_step`` over contiguous caches) and the paged-serving
entry points (``prefill_paged``, ``decode_paged``, ``verify_paged``; GQA
stacks with any FFN).

Parameters are a plain dict of tensors in the reference's layout:
``embed`` (V, d); ``prefix`` {"l{i}": layer}; ``units`` {"l{i}": layer},
every leaf stacked on a leading ``num_units`` dim; ``final_norm`` (d,);
``lm_head`` (d, V_padded).  An attention layer holds ln1, wq (d, H, Dh),
wk/wv (d, KV, Dh), wo (H, Dh, d); an MLA layer ln1, w_dq (d, q_lora),
q_ln, w_uq (q_lora, H, nope+rope) (or w_q (d, H, nope+rope) without a q
LoRA), w_dkv (d, r), kv_ln, w_kr (d, rope), w_uk (r, H, nope), w_uv (r,
H, v_head), wo (H, v_head, d); an "mlp" FFN ln2, w_gate/w_up (d, d_ff),
w_down (d_ff, d); a "moe" FFN ln2, router (d, E), w_gate/w_up (E, d,
d_ff_expert), w_down (E, d_ff_expert, d) and, with shared experts,
shared_gate/shared_up (d, n_shared * d_ff_expert), shared_down
(n_shared * d_ff_expert, d).  With the same layout, weights carried over
from the JAX package (``convert.params_from_numpy``) compute the same
function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import VerifyWindow
from repro_torch.models.layers import lm_loss, rms_norm
from repro_torch.models.transformer import stack_apply, stack_apply_paged


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

        def experts(*shape):
            """(E, a, b) expert weights (after any leading stack dim),
            drawn one expert at a time: one f32 draw of every expert at
            once would need a temporary twice the leaf's size."""
            w = torch.empty(shape, dtype=dt, device=dev)
            for idx in np.ndindex(*shape[:-2]):
                w[idx] = dense(*shape[-2:])
            return w

        def layer(mixer, ffn, stack=0):
            if mixer not in ("attn", "mla") or ffn not in ("mlp", "moe",
                                                           "none"):
                raise ValueError(f"the port supports attn/mla layers with "
                                 f"mlp/moe/none FFNs, got {(mixer, ffn)}")
            lead = (stack,) if stack else ()
            d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)

            def ones(*shape):
                return torch.ones(lead + shape, dtype=dt, device=dev)

            p = {"ln1": ones(d)}
            if mixer == "attn":
                p.update(wq=dense(*lead, d, H, hd),
                         wk=dense(*lead, d, KV, hd),
                         wv=dense(*lead, d, KV, hd),
                         wo=dense(*lead, H, hd, d))
            else:
                qk, r = cfg.qk_head_dim, cfg.kv_lora_rank
                if cfg.q_lora_rank:
                    p.update(w_dq=dense(*lead, d, cfg.q_lora_rank),
                             q_ln=ones(cfg.q_lora_rank),
                             w_uq=dense(*lead, cfg.q_lora_rank, H, qk))
                else:
                    p.update(w_q=dense(*lead, d, H, qk))
                p.update(w_dkv=dense(*lead, d, r), kv_ln=ones(r),
                         w_kr=dense(*lead, d, cfg.qk_rope_dim),
                         w_uk=dense(*lead, r, H, cfg.qk_nope_dim),
                         w_uv=dense(*lead, r, H, cfg.v_head_dim),
                         wo=dense(*lead, H, cfg.v_head_dim, d))
            if ffn == "mlp":
                p.update(ln2=ones(d),
                         w_gate=dense(*lead, d, cfg.d_ff),
                         w_up=dense(*lead, d, cfg.d_ff),
                         w_down=dense(*lead, cfg.d_ff, d))
            elif ffn == "moe":
                E, fe = cfg.num_experts, cfg.d_ff_expert
                p.update(ln2=ones(d), router=dense(*lead, d, E),
                         w_gate=experts(*lead, E, d, fe),
                         w_up=experts(*lead, E, d, fe),
                         w_down=experts(*lead, E, fe, d))
                if cfg.num_shared_experts:
                    fs = cfg.num_shared_experts * fe
                    p.update(shared_gate=dense(*lead, d, fs),
                             shared_up=dense(*lead, d, fs),
                             shared_down=dense(*lead, fs, d))
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
    # Full-sequence forward (the reference's logits / prefill / decode_step)
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        """Token embeddings; frontend "none" with rope or no positional
        encoding (rope is applied inside attention)."""
        cfg = self.cfg
        if cfg.frontend != "none" or cfg.positional not in ("rope", "none"):
            raise ValueError(f"the port embeds tokens with rope or no "
                             f"positions, got frontend {cfg.frontend!r}, "
                             f"positional {cfg.positional!r}")
        return params["embed"][tokens.long()]

    def _lm_head(self, params, x):
        """Final norm and the lm_head product in f32 (exact products of the
        stored values, f32 sums), as the reference's
        ``preferred_element_type=float32``; padded vocab columns cut."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = x.float() @ self._head_f32(params["lm_head"])
        return logits[..., :self.cfg.vocab_size]

    def _loss_mask(self, batch):
        """Ones over ``batch["labels"]``: every position is a target.  The
        reference's vision frontend masks its patch positions; the port
        has no frontends (``_embed`` refuses them too)."""
        if self.cfg.frontend == "vision_patches":
            raise ValueError("the port has no vision frontend: no loss mask "
                             "for patch positions")
        return torch.ones_like(batch["labels"], dtype=torch.float32)

    def loss(self, params, batch):
        """Mean next-token NLL of ``batch["tokens"]`` (B, S) against
        ``batch["labels"]`` (B, S), a 0-d f32 tensor; differentiable in the
        parameters.  The head is ``params["lm_head"]`` itself (never the
        cached f32 copy of ``_head_f32``, made outside autograd), through
        ``lm_loss``."""
        x = self._embed(params, batch["tokens"])
        x, _ = stack_apply(x, params, self.cfg, "train")
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return lm_loss(x, params["lm_head"], batch["labels"],
                       self._loss_mask(batch), self.cfg.vocab_size)

    def logits(self, params, batch):
        """Full-sequence logits (B, S, V) f32 of ``batch["tokens"]`` (B, S);
        one ``flash_attention`` launch per layer."""
        x = self._embed(params, batch["tokens"])
        x, _ = stack_apply(x, params, self.cfg, "train")
        return self._lm_head(params, x)

    def prefill(self, params, batch):
        """Prompt forward: returns (logits (B, V) f32 at the last position,
        caches) for ``batch["tokens"]`` (B, S); caches as ``cache_specs(B,
        S)``."""
        x = self._embed(params, batch["tokens"])
        x, caches = stack_apply(x, params, self.cfg, "prefill")
        return self._lm_head(params, x[:, -1]), caches

    def decode_step(self, params, caches, tokens, index):
        """One token per sequence: tokens (B, 1) int at position ``index``
        (an int or a one-element tensor; the next write slot, below the
        caches' length).  The caches are written IN PLACE and returned.
        Returns (logits (B, V) f32, caches)."""
        if not isinstance(index, torch.Tensor):
            index = torch.full((1,), int(index), dtype=torch.long,
                               device=tokens.device)
        x = self._embed(params, tokens)
        x, caches = stack_apply(x, params, self.cfg, "decode", caches=caches,
                                index=index)
        return self._lm_head(params, x)[:, 0], caches

    def cache_specs(self, B: int, S: int):
        """Caches of the full-sequence forward as ``meta`` tensors, per
        layer: "attn" k/v (B, S, KV, Dh); "mla" ckv (B, S, r) and kr (B, S,
        rope).  Unit caches carry the leading num_units dim."""
        cfg = self.cfg
        dt = _dtype(cfg)

        def cache(mixer, *lead):
            def t(*shape):
                return torch.empty(lead + shape, dtype=dt, device="meta")
            if mixer == "attn":
                KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
                return {"k": t(B, S, KV, hd), "v": t(B, S, KV, hd)}
            if mixer == "mla":
                return {"ckv": t(B, S, cfg.kv_lora_rank),
                        "kr": t(B, S, cfg.qk_rope_dim)}
            raise ValueError(f"no cache for mixer {mixer!r} in the port")

        return {"prefix": tuple(cache(m) for m, _ in cfg.prefix_pattern),
                "units": {f"l{i}": cache(m, cfg.num_units)
                          for i, (m, _) in enumerate(cfg.unit_pattern)}}

    def init_caches(self, B: int, S: int, device):
        """Zero caches of ``cache_specs(B, S)`` on ``device``."""
        specs = self.cache_specs(B, S)

        def zeros(c):
            return {n: torch.zeros(s.shape, dtype=s.dtype, device=device)
                    for n, s in c.items()}

        return {"prefix": tuple(zeros(c) for c in specs["prefix"]),
                "units": {k: zeros(c) for k, c in specs["units"].items()}}

    # ------------------------------------------------------------------
    def supports_paged(self) -> bool:
        """Paged serving covers pure-attention stacks (any FFN) with rope
        or no positional encoding and no modality frontend, as the
        reference's: recurrent mixers have no paged state and sinusoidal
        embeds would need per-sequence position offsets."""
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
        return self._lm_head(params, x)[:, 0], pages

    def verify_paged(self, params, pages, tokens, pos0, widths,
                     block_tables, rows=None):
        """Speculative verification forward: score all W window positions
        of every lane in one pass.  tokens (B, W) int32, row 0 the last
        accepted token and rows 1.. the drafts (rows at or past
        ``widths[b]`` are padding); pos0 (B,) int32, row 0's KV slot;
        widths (B,) int32; block_tables (B, n_max) int32.  Returns
        (logits (B, W, V) f32, pages), the pools written in place.

        ``rows`` (n_slabs, S) int64 names the window rows to compute by
        their flat index b*W + s, one slab per row-wise call; entries equal
        to B*W pad a slab.  Default: W slabs of B rows, slab s holding row
        s of every lane; ``verify_slabs`` packs the live rows alone.  Every
        row-wise op (embedding, norms, projections, rope, MLP, f32 lm_head)
        runs once per slab and attention goes through one
        ``fused_verify_attention`` launch per layer on the (B, W) window,
        so a computed live row's logits are bitwise the ``decode_paged``
        logits of the same token at the same position in an S-lane call.
        Rows not computed have logits 0."""
        B, W = tokens.shape
        dev = tokens.device
        if rows is None:
            rows = torch.arange(B * W, device=dev).view(B, W).T
        steps = torch.arange(W, dtype=pos0.dtype, device=dev)
        tok = torch.cat([tokens.reshape(-1), tokens.new_zeros(1)]).long()
        pos = torch.cat([(pos0[:, None] + steps).reshape(-1),
                         pos0.new_zeros(1)])
        win = VerifyWindow(pos0, widths, W, rows, rows.clamp(max=B * W - 1),
                           pos[rows])
        x = [params["embed"][t[:, None]] for t in tok[rows]]
        x, pages = stack_apply_paged(x, params, self.cfg, "verify", pages,
                                     block_tables, win)
        logits = x[0].new_zeros((B * W + 1, self.cfg.vocab_size),
                                dtype=torch.float32)
        logits[rows.reshape(-1)] = torch.cat(
            [self._lm_head(params, xs)[:, 0] for xs in x])
        return logits[:B * W].view(B, W, -1), pages


def verify_slabs(widths, W: int, slab: int) -> np.ndarray:
    """``rows`` for ``Model.verify_paged`` that compute the live window
    rows alone: the flat indices b*W + s of rows s < widths[b], in order,
    packed into ceil(live / slab) slabs of ``slab`` rows (at least one),
    the last padded with B*W.  ``widths``: host-side (B,) ints.  Returns
    (n_slabs, slab) int64."""
    widths = np.asarray(widths)
    live = np.flatnonzero(np.arange(W)[None, :] < widths[:, None])
    n = max(1, -(-live.size // slab))
    out = np.full(n * slab, widths.shape[0] * W, np.int64)
    out[:live.size] = live
    return out.reshape(n, slab)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
