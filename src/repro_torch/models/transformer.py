"""Layer assembly for paged serving: attention + SwiGLU blocks, the prefix
layers, then ``num_units`` repetitions of the unit pattern.  Unit
parameters and page pools carry a leading ``num_units`` dim, as in the
reference; a Python loop over units takes the place of ``lax.scan``."""

from __future__ import annotations

from repro_torch.models.attention import gqa_decode_paged, gqa_prefill_paged
from repro_torch.models.layers import mlp, rms_norm


def layer_apply_paged(x, lp, mixer, ffn, cfg, mode, pages, tables, pos,
                      n=None, fused=False):
    if mixer != "attn":
        raise ValueError(
            f"paged serving supports 'attn' mixers only, got {mixer!r}")
    if ffn not in ("mlp", "none"):
        raise ValueError(f"paged serving supports 'mlp' FFNs only, got "
                         f"{ffn!r}")
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mode == "prefill":
        mix_out, new_pages = gqa_prefill_paged(h, lp, cfg, pages, tables,
                                               pos, n)
    elif mode == "decode":
        mix_out, new_pages = gqa_decode_paged(h, lp, cfg, pages, tables, pos,
                                              fused=fused)
    else:
        raise ValueError(f"unknown paged mode {mode!r} (prefill | decode)")
    x = x + mix_out
    if ffn == "mlp":
        x = x + mlp(rms_norm(x, lp["ln2"], cfg.norm_eps), lp)
    return x, new_pages


def stack_apply_paged(x, params, cfg, mode, pages, tables, pos, n=None,
                      fused=False):
    """mode "prefill": ``tables`` is one sequence's (n_max,) block table,
    ``pos`` the chunk's start offset, ``n`` the real chunk length (rows past
    it are padding).  mode "decode": ``tables`` is (B, n_max), ``pos`` the
    per-sequence write positions (B,).  The pools are written in place.
    Returns (x, pages)."""
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        x, _ = layer_apply_paged(x, params["prefix"][f"l{i}"], mixer, ffn,
                                 cfg, mode, pages["prefix"][i], tables, pos,
                                 n, fused)
    for u in range(cfg.num_units):
        for i, (mixer, ffn) in enumerate(cfg.unit_pattern):
            key = f"l{i}"
            lp = {name: leaf[u] for name, leaf in params["units"][key].items()}
            up = {name: leaf[u] for name, leaf in pages["units"][key].items()}
            x, _ = layer_apply_paged(x, lp, mixer, ffn, cfg, mode, up, tables,
                                     pos, n, fused)
    return x, pages
