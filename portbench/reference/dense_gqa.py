"""Plain reference of a dense GQA decoder (``"arch": "dense_gqa"``), in
float32 PyTorch, layer by layer.

Each layer: x += o(attn(rope(q(n(x))), rope(k(n(x))), v(n(x)))), then
x += down(silu(gate(n(x))) * up(n(x))), with n the RMS norm (its weights
are ones) and causal softmax attention in which query head h reads
key/value head h // (H / KV).  Rope rotates the two halves of a head
(x1 cos - x2 sin, x1 sin + x2 cos) by position x theta^(-i / half).
Then the final RMS norm and the lm_head; the logits of the padded vocab
columns are cut.  Matrix products run in full float32: TF32 is off.

The weights are the configuration's, drawn again from the run's seed by a
frozen copy of the draw rule of the port's ``Model.init``
(``src/repro_torch/models/model.py``): one generator on the device seeded
with the seed; in order the embedding (V, d), then per layer kind, stacked
over the layers, wq (L, d, H, Dh), wk and wv (L, d, KV, Dh), wo (L, H, Dh,
d), w_gate and w_up (L, d, F), w_down (L, F, d), then the lm_head (d, V
rounded up to 256); each a float32 standard normal times 0.02, rounded to
the served dtype.  Norm weights are ones and draw nothing.

``fp8=True`` is the control: every matrix product's operands rounded to
float8 e4m3 (weights per output column, activations per row, each scaled
to the format's largest value 448) before the float32 product, the
nearest precision below the configuration's bfloat16.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

E4M3_MAX = 448.0


def _dims(cfg: Dict):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return (d, H, cfg["num_key_value_heads"], cfg.get("head_dim") or d // H,
            cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def draw_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed`` (see the module's
    docstring), in the served dtype, on ``device``."""
    d, H, KV, Dh, F, V, L = _dims(cfg)
    dt = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(0.02).to(dt)

    w = {"embed": dense(V, d)}
    for name, shape in (("wq", (L, d, H, Dh)), ("wk", (L, d, KV, Dh)),
                        ("wv", (L, d, KV, Dh)), ("wo", (L, H, Dh, d)),
                        ("w_gate", (L, d, F)), ("w_up", (L, d, F)),
                        ("w_down", (L, F, d))):
        w[name] = dense(*shape)
    w["lm_head"] = dense(d, -(-V // 256) * 256)
    return w


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, Dh) at positions 0..T-1."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (np.arange(0, half) / half))
    inv = torch.as_tensor(inv.astype(np.float32), device=x.device)
    ang = torch.arange(x.shape[0], device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to e4m3, scaled per slice along ``dim`` to its amax."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Layer:
    """One layer's weights in float32, as (in, out) matrices."""

    def __init__(self, w, i: int, fp8: bool):
        d = w["wq"].shape[1]
        mats = dict(q=w["wq"][i].reshape(d, -1), k=w["wk"][i].reshape(d, -1),
                    v=w["wv"][i].reshape(d, -1),
                    o=w["wo"][i].reshape(-1, d), gate=w["w_gate"][i],
                    up=w["w_up"][i], down=w["w_down"][i])
        self.m = {k: _fp8(m.float(), 0) if fp8 else m.float()
                  for k, m in mats.items()}
        self.fp8 = fp8

    def mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return (_fp8(x, -1) if self.fp8 else x) @ self.m[name]


def _attend(q, k, v):
    """Causal attention: q (T, H, Dh), k/v (T, KV, Dh) -> (T, H * Dh)."""
    T, H, Dh = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) * Dh ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v) \
        .reshape(T, H * Dh)


@torch.no_grad()
def logits(cfg: Dict, w: Dict[str, torch.Tensor],
           seqs: Sequence[torch.Tensor], at: Sequence[torch.Tensor],
           fp8: bool = False) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (T_i,) int, the logits (n_i, V)
    f32 at its positions ``at[i]`` (n_i,), each the distribution of the
    token after that position.  Layer by layer over all sequences."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        d, H, KV, Dh, F, V, L = _dims(cfg)
        eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
        xs = [w["embed"][s.long()].float() for s in seqs]
        for i in range(L):
            lay = _Layer(w, i, fp8)
            for j, x in enumerate(xs):
                h = _rms(x, eps)
                q = _rope(lay.mm(h, "q").view(-1, H, Dh), theta)
                k = _rope(lay.mm(h, "k").view(-1, KV, Dh), theta)
                v = lay.mm(h, "v").view(-1, KV, Dh)
                x = x + lay.mm(_attend(q, k, v), "o")
                h = _rms(x, eps)
                g = lay.mm(h, "gate")
                x = x + lay.mm(g * torch.sigmoid(g) * lay.mm(h, "up"),
                               "down")
                xs[j] = x
            del lay
        head = w["lm_head"].float()[:, :V]
        if fp8:
            head = _fp8(head, 0)
        out = []
        for x, pos in zip(xs, at):
            h = _rms(x[pos.long()], eps)
            out.append((_fp8(h, -1) if fp8 else h) @ head)
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
