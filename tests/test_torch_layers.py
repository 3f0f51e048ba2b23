"""Port layers (repro_torch.models.layers) against the JAX package's
(repro.models.layers): same numpy inputs, f32, atol 1e-5."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models.partition import NULL_CTX  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 3, 64), (1, 5, 2048)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_silu():
    x = np.linspace(-8, 8, 257, dtype=np.float32)
    _close(tl.silu(torch.tensor(x)), jl.silu(jnp.asarray(x)))


@pytest.mark.parametrize("head_dim,theta,pos_shape", [
    (16, 10000.0, (7,)),            # prefill: (S,)
    (64, 10000.0, (4, 1)),          # decode: (B, 1) per-lane positions
    (128, 500000.0, (3,)),
])
def test_rope_tables(head_dim, theta, pos_shape):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, size=pos_shape).astype(np.int32)
    ct, st = tl.rope_tables(torch.tensor(pos), head_dim, theta)
    cj, sj = jl.rope_tables(jnp.asarray(pos), head_dim, theta)
    assert tuple(ct.shape) == cj.shape
    _close(ct, cj)
    _close(st, sj)


@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_rope(per_lane):
    rng = np.random.default_rng(2)
    B, S, H, Dh = 3, 5, 4, 16
    x = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    pos = (rng.integers(0, 300, size=(B, S)) if per_lane
           else np.arange(S) + 11).astype(np.int32)
    ct, st = tl.rope_tables(torch.tensor(pos), Dh, 10000.0)
    cj, sj = jl.rope_tables(jnp.asarray(pos), Dh, 10000.0)
    _close(tl.apply_rope(torch.tensor(x), ct, st),
           jl.apply_rope(jnp.asarray(x), cj, sj))


def test_mlp():
    rng = np.random.default_rng(3)
    d, f = 64, 128
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    p = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in
         (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    got = tl.mlp(torch.tensor(x), {k: torch.tensor(v) for k, v in p.items()})
    want = jl.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  NULL_CTX)
    _close(got, want)
