"""The reference's model API (``repro.models.model``) on PyTorch tensors,
for "attn" (GQA), "mla", "mamba", "mlstm" and "slstm" mixers with "mlp",
"moe" or "none" FFNs: the training loss (``loss``), the full-sequence
forward (``logits``, ``prefill``, ``decode_step`` over contiguous and
recurrent caches), ``cache_specs`` / ``input_specs`` and the
paged-serving entry points (``prefill_paged``, ``decode_paged``,
``verify_paged``; GQA stacks with any FFN, rope or no positions and no
frontend, as the reference's ``supports_paged``).

Batch dict keys by frontend (``input_specs``):
  none            : tokens (B,S) int32, labels (B,S) int32
  audio_frames    : frames (B,S,D) model dtype, labels (B,S) int32
  vision_patches  : patches (B,P,D), tokens (B,S-P) int32, labels (B,S)
                    int32 (the loss masked to the text positions)
Decode takes tokens for every frontend; ``positional == "sinusoidal"``
adds the sinusoidal table to the embeddings.

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
(n_shared * d_ff_expert, d).  Mamba and xLSTM layers hold ln1 and the
leaves named in ``models/mamba.py`` and ``models/xlstm.py``; a layer with
an FFN of "none" has no ln2.  With the same layout, weights carried over
from the JAX package (``convert.params_from_numpy``) compute the same
function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import Shape
from repro_torch.models import paged_graphs as pg
from repro_torch.models.attention import VerifyWindow
from repro_torch.models.layers import lm_loss, rms_norm, sinusoidal_embedding
from repro_torch.models.partition import NULL_CTX, AxisCtx
from repro_torch.models.transformer import (FFNS, MIXERS, stack_apply,
                                            stack_apply_paged)
from repro_torch.obs.spans import NULL_SPANS


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # the mesh context (models.partition): the paged entry points'
    # serving-TP collectives, the full-sequence forward's expert parallelism
    ctx: AxisCtx = NULL_CTX
    # [lm_head, its version counter, its f32 copy]; see _head_state
    _head: Any = dataclasses.field(default=None, repr=False, compare=False)
    # wall-clock spans of the paged entry points (obs/spans.py); the
    # serving backend attaches its recorder here
    spans: Any = dataclasses.field(default=NULL_SPANS, repr=False,
                                   compare=False)
    # CUDA graphs of the paged decode and prefill forwards, one per call
    # shape (models/paged_graphs.py); ``_paged_call`` replays them
    graphs: pg.PagedGraphs = dataclasses.field(
        default_factory=pg.PagedGraphs, repr=False, compare=False)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random weights (normal, std 0.02, mamba's w_dt 0.1; norms ones)
        on the generator's device, in the model dtype; mamba's dt_bias
        (zeros), A_log (log 1..d_state on every channel) and D (ones) in
        float32, as the reference's ``_init_layer``.  ``generator`` None
        gives ``meta`` tensors of the same shapes and dtypes
        (``param_specs``)."""
        cfg = self.cfg
        meta = generator is None
        dt = _dtype(cfg)
        dev = torch.device("meta") if meta else generator.device

        def dense(*shape, scale=0.02):
            if meta:
                return torch.empty(shape, dtype=dt, device=dev)
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (w * scale).to(dt)

        def experts(*shape):
            """(E, a, b) expert weights (after any leading stack dim),
            drawn one expert at a time: one f32 draw of every expert at
            once would need a temporary twice the leaf's size."""
            w = torch.empty(shape, dtype=dt, device=dev)
            if meta:
                return w
            for idx in np.ndindex(*shape[:-2]):
                w[idx] = dense(*shape[-2:])
            return w

        def layer(mixer, ffn, stack=0):
            if mixer not in MIXERS or ffn not in FFNS:
                raise ValueError(f"the port supports {sorted(MIXERS)} layers "
                                 f"with {FFNS} FFNs, got {(mixer, ffn)}")
            lead = (stack,) if stack else ()
            d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim)

            def ones(*shape, dtype=dt):
                return torch.ones(lead + shape, dtype=dtype, device=dev)

            def zeros(*shape, dtype=dt):
                return torch.zeros(lead + shape, dtype=dtype, device=dev)

            p = {"ln1": ones(d)}
            if mixer == "mamba":
                di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
                alog = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                              device=dev))
                p.update(w_in=dense(*lead, d, 2 * di),
                         conv_w=dense(*lead, cfg.mamba_d_conv, di),
                         conv_b=zeros(di),
                         w_x=dense(*lead, di, cfg.resolved_dt_rank + 2 * ds),
                         w_dt=dense(*lead, cfg.resolved_dt_rank, di,
                                    scale=0.1),
                         dt_bias=zeros(di, dtype=torch.float32),
                         A_log=alog.expand(lead + (di, ds)).clone(),
                         D=ones(di, dtype=torch.float32),
                         w_out=dense(*lead, di, d))
            elif mixer in ("mlstm", "slstm"):
                Hx = cfg.xlstm_num_heads
                dh = d // Hx
                if mixer == "mlstm":
                    p.update(w_q=dense(*lead, d, Hx, dh),
                             w_k=dense(*lead, d, Hx, dh),
                             w_v=dense(*lead, d, Hx, dh),
                             w_i=dense(*lead, d, Hx), w_f=dense(*lead, d, Hx),
                             w_og=dense(*lead, d, d),
                             w_down=dense(*lead, d, d))
                else:
                    p.update({w: dense(*lead, d, Hx, dh)
                              for w in ("w_z", "w_i", "w_f", "w_o")})
                    p.update({r: dense(*lead, Hx, dh, dh)
                              for r in ("r_z", "r_i", "r_f", "r_o")})
            elif mixer == "attn":
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

    def param_specs(self) -> Dict[str, Any]:
        """``meta`` tensors of ``init``'s shapes and dtypes (the reference's
        ``jax.eval_shape(model.init, key)``)."""
        return self.init(None)

    # ------------------------------------------------------------------
    # Full-sequence forward (the reference's logits / prefill / decode_step)
    # ------------------------------------------------------------------
    def _embed(self, params, batch, mode, index=None):
        """The stack's input (B, S, d) in the model dtype, as the
        reference's ``_embed``: token embeddings in decode (``index``, the
        (1,) position tensor) and for frontend "none"; the frames for
        "audio_frames"; the patches before the token embeddings for
        "vision_patches"; plus the sinusoidal table when ``positional`` is
        "sinusoidal" (rope is applied inside attention)."""
        cfg = self.cfg
        dt = _dtype(cfg)
        if mode == "decode" or cfg.frontend not in ("audio_frames",
                                                    "vision_patches"):
            x = params["embed"][batch["tokens"].long()]
        elif cfg.frontend == "audio_frames":
            x = batch["frames"].to(dt)
        else:
            te = params["embed"][batch["tokens"].long()]
            x = torch.cat([batch["patches"].to(dt), te], dim=1)
        if cfg.positional == "sinusoidal":
            pos = (index if mode == "decode"
                   else torch.arange(x.shape[1], device=x.device))
            x = x + sinusoidal_embedding(pos, cfg.d_model)[None].to(dt)
        return x

    def _lm_head(self, params, x):
        """Final norm and the lm_head product in f32 (exact products of the
        stored values, f32 sums), as the reference's
        ``preferred_element_type=float32``; under serving TP the rank's
        vocab columns are gathered (``ctx.gather_vocab``) before the padded
        columns are cut."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = x.float() @ self._head_f32(params["lm_head"])
        logits = self.ctx.gather_vocab(logits)
        return logits[..., :self.cfg.vocab_size]

    def _loss_mask(self, batch):
        """(B, S) f32 over ``batch["labels"]``: ones, or for the vision
        frontend ones at the text positions (at or past ``num_patches``)
        and zeros at the patches."""
        lab = batch["labels"]
        mask = torch.ones_like(lab, dtype=torch.float32)
        if self.cfg.frontend == "vision_patches":
            text = torch.arange(lab.shape[1], device=lab.device) \
                >= self.cfg.num_patches
            mask = text[None, :].float() * mask
        return mask

    def loss(self, params, batch):
        """Mean next-token NLL of the batch (keys by frontend, as
        ``input_specs``) against ``batch["labels"]`` (B, S) under
        ``_loss_mask``, a 0-d f32 tensor; differentiable in the
        parameters.  The head is ``params["lm_head"]`` itself (never the
        cached f32 copy of ``_head_f32``, made outside autograd), through
        ``lm_loss``."""
        x = self._embed(params, batch, "train")
        x, _ = stack_apply(x, params, self.cfg, "train", ctx=self.ctx)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return lm_loss(x, params["lm_head"], batch["labels"],
                       self._loss_mask(batch), self.cfg.vocab_size)

    def logits(self, params, batch):
        """Full-sequence logits (B, S, V) f32 of the batch (keys by
        frontend; labels not needed); one ``flash_attention`` launch per
        attention layer."""
        x = self._embed(params, batch, "train")
        x, _ = stack_apply(x, params, self.cfg, "train", ctx=self.ctx)
        return self._lm_head(params, x)

    def prefill(self, params, batch):
        """Prompt forward: returns (logits (B, V) f32 at the last position,
        caches) for the batch (keys by frontend) of S positions; caches as
        ``cache_specs(B, S)``."""
        x = self._embed(params, batch, "prefill")
        x, caches = stack_apply(x, params, self.cfg, "prefill",
                                ctx=self.ctx)
        return self._lm_head(params, x[:, -1]), caches

    def decode_step(self, params, caches, tokens, index):
        """One token per sequence: tokens (B, 1) int at position ``index``
        (an int or a one-element tensor; the next write slot, below the
        caches' length), for every frontend.  The caches are written IN
        PLACE and returned.  Returns (logits (B, V) f32, caches)."""
        if not isinstance(index, torch.Tensor):
            index = torch.full((1,), int(index), dtype=torch.long,
                               device=tokens.device)
        x = self._embed(params, {"tokens": tokens}, "decode",
                        index.reshape(1))
        x, caches = stack_apply(x, params, self.cfg, "decode", caches=caches,
                                index=index, ctx=self.ctx)
        return self._lm_head(params, x)[:, 0], caches

    def cache_specs(self, B: int, S: int):
        """Caches of the full-sequence forward as ``meta`` tensors, per
        layer: "attn" k/v (B, S, KV, Dh); "mla" ckv (B, S, r) and kr (B, S,
        rope), in the model dtype; the recurrent states in f32, whatever
        S: "mamba" conv (B, dc-1, di) and ssm (B, di, ds); "mlstm" C (B, H,
        dh, dh), n (B, H, dh), m (B, H); "slstm" c, n, h, m (B, H, dh).
        Unit caches carry the leading num_units dim."""
        cfg = self.cfg
        dt = _dtype(cfg)

        def cache(mixer, *lead):
            def t(*shape, dtype=dt):
                return torch.empty(lead + shape, dtype=dtype, device="meta")
            f32 = torch.float32
            if mixer == "attn":
                KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
                return {"k": t(B, S, KV, hd), "v": t(B, S, KV, hd)}
            if mixer == "mla":
                return {"ckv": t(B, S, cfg.kv_lora_rank),
                        "kr": t(B, S, cfg.qk_rope_dim)}
            if mixer == "mamba":
                di = cfg.mamba_d_inner
                return {"conv": t(B, cfg.mamba_d_conv - 1, di, dtype=f32),
                        "ssm": t(B, di, cfg.mamba_d_state, dtype=f32)}
            Hx = cfg.xlstm_num_heads
            dh = cfg.d_model // Hx
            if mixer == "mlstm":
                return {"C": t(B, Hx, dh, dh, dtype=f32),
                        "n": t(B, Hx, dh, dtype=f32),
                        "m": t(B, Hx, dtype=f32)}
            if mixer == "slstm":
                return {name: t(B, Hx, dh, dtype=f32)
                        for name in ("c", "n", "h", "m")}
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

    def input_specs(self, shape: Shape) -> Dict[str, Any]:
        """``meta`` tensors standing in for every model input of a shape
        cell, as the reference's ``input_specs``: "train" {"batch": the
        frontend's keys with labels}, "prefill" {"batch": without labels},
        "decode" {"caches": ``cache_specs(B, seq_len)``, "tokens" (B, 1),
        "index" ()}."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dt = _dtype(cfg)

        def t(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"caches": self.cache_specs(B, S), "tokens": t(B, 1),
                    "index": t()}
        if cfg.frontend == "audio_frames":
            batch = {"frames": t(B, S, cfg.d_model, dtype=dt)}
        elif cfg.frontend == "vision_patches":
            batch = {"patches": t(B, cfg.num_patches, cfg.d_model, dtype=dt),
                     "tokens": t(B, S - cfg.num_patches)}
        else:
            batch = {"tokens": t(B, S)}
        if shape.kind == "train":
            batch["labels"] = t(B, S)
        return {"batch": batch}

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
        already resident; block_table: (n_max,).  No logits: the first
        decode step re-runs the final prompt token.  Writes the pools in
        place and returns them.

        ``start`` and ``n`` are host ints; the forward takes them as 0-d
        device tensors, so one forward serves every chunk of its shape.
        On CUDA at tp=1 the call replays a CUDA graph of
        ``_prefill_forward`` for its shape (C, n_max), as ``_paged_call``
        says; a replay writes the pages bitwise as the eager forward
        does."""
        def forward(tokens, start, block_table, n):
            self._prefill_forward(params, pages, tokens, start, block_table,
                                  n)

        self._paged_call(("prefill", tokens.shape[1], block_table.shape[0]),
                         params, pages, forward,
                         (tokens, start, block_table, n),
                         rows=tokens.shape[1], tokens=n)
        return pages

    def _prefill_forward(self, params, pages, tokens, start, block_table,
                         n):
        """The eager forward of ``prefill_paged``: ``start`` and ``n`` are
        0-d int64 tensors on the tokens' device, as ``prefill_paged``
        passes them, or host ints (the same ops either way)."""
        with self.spans.span("model.embed"):
            x = params["embed"][tokens.long()]
        _, pages = stack_apply_paged(x, params, self.cfg, "prefill", pages,
                                     block_table, start, n, ctx=self.ctx,
                                     spans=self.spans)
        return pages

    def _head_state(self, head: torch.Tensor) -> list:
        """[head, its version counter, its f32 copy or None]: one list per
        lm_head tensor, made again after an in-place change to it.  It is
        part of the paged calls' graph owner (``_paged_call``), which keeps
        the f32 copy a decode graph reads allocated."""
        h = self._head
        if h is None or h[0] is not head or h[1] != head._version:
            h = self._head = [head, head._version, None]
        return h

    def _head_f32(self, head: torch.Tensor) -> torch.Tensor:
        """f32 copy of the lm_head (under serving TP the rank's shard of
        it), made once per head tensor (and again after an in-place change
        to it) instead of in every forward."""
        h = self._head_state(head)
        if h[2] is None:
            h[2] = head.float()
        return h[2]

    def decode_paged(self, params, pages, tokens, positions, block_tables,
                     *, fused: bool = False):
        """One batched decode step: tokens (B, 1) int32 at per-sequence
        write positions (B,) int32; block_tables (B, n_max) int32.  Returns
        (logits (B, V) f32, pages), the pools written in place.  The
        lm_head product runs in f32 (exact products of the stored values,
        f32 sums), as the reference's ``preferred_element_type=float32``.

        On CUDA at tp=1 the call replays a CUDA graph of
        ``_decode_forward`` for its shape (B, n_max, fused), as
        ``_paged_call`` says.  A replay runs the eager forward's kernels at
        its shapes and in its order, on the same weights and pools, so its
        logits are bitwise the eager forward's; they are a copy the next
        call does not overwrite."""
        def forward(tokens, positions, block_tables):
            return self._decode_forward(params, pages, tokens, positions,
                                        block_tables, fused=fused)[0]

        logits = self._paged_call(
            ("decode", tokens.shape[0], block_tables.shape[1], fused),
            params, pages, forward, (tokens, positions, block_tables),
            rows=tokens.shape[0])
        return logits, pages

    def _decode_forward(self, params, pages, tokens, positions,
                        block_tables, *, fused: bool):
        """The eager decode forward of ``decode_paged``."""
        with self.spans.span("model.embed"):
            x = params["embed"][tokens.long()]
        x, pages = stack_apply_paged(x, params, self.cfg, "decode", pages,
                                     block_tables, positions, fused=fused,
                                     ctx=self.ctx, spans=self.spans)
        with self.spans.span("model.lm_head"):
            logits = self._lm_head(params, x)
        return logits[:, 0], pages

    def _paged_call(self, key, params, pages, forward, inputs, **attrs):
        """``forward(*inputs)`` of a paged entry point, ``key`` its kind and
        shape, in a ``model.<kind>`` span with ``attrs``.  On CUDA at tp=1
        (``paged_graphs.usable``) the call goes through the graph table:
        the shape's first call runs eager, its second captures the graph
        and replays it, later ones replay; new ``params`` or ``pages`` dicts
        or a changed lm_head drop every graph.  Otherwise it runs eager.
        Host ints in ``inputs`` reach the forward as 0-d device tensors.
        The span's ``graphed`` is 1 when a graph computes the call; such a
        call runs with the recorder detached, so a capture records no spans
        inside it.  Returns the forward's output."""
        graphs, spans = self.graphs, self.spans
        owner = (params, pages, self._head_state(params["lm_head"]))
        usable = pg.usable(self.ctx, *inputs)
        graphed = usable and graphs.graphed(key, owner)
        with spans.span("model." + key[0], **attrs, graphed=int(graphed)):
            if not usable:
                return forward(*pg.on_device(inputs))
            if graphed:
                self.spans = NULL_SPANS
            try:
                return graphs.run(key, owner, forward, inputs)
            finally:
                self.spans = spans

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
                                     block_tables, win, ctx=self.ctx)
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


def build_model(cfg: ModelConfig, ctx: Optional[AxisCtx] = None) -> Model:
    """The model of ``cfg``; ``ctx`` carries the serving-TP collectives of
    one rank (``launch.sharding.serving_tp_ctx``) or a mesh context
    (``launch.sharding.make_ctx``); None is ``NULL_CTX``."""
    return Model(cfg, NULL_CTX if ctx is None else ctx)
