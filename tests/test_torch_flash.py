"""The port's flash attention (repro_torch.kernels.flash_attention) on the
CPU, where the wrapper runs its plain version, against the JAX package: the
Pallas ``flash_attention`` in interpret mode and its oracle
``flash_attention_ref`` on a subset of the reference's sweep, and the
reference's ``causal_attention`` (both schedules) at ragged S and Dk != Dv,
which the Pallas kernel cannot take.  Tolerances are the reference's own
(``tests/test_kernels.py``): 3e-5 in f32, 2.5e-2 in bf16."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref as j_ref  # noqa: E402
from repro.models.attention import \
    causal_attention as j_causal  # noqa: E402
from repro.models.partition import AxisCtx  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = {"float32": 3e-5, "bfloat16": 2.5e-2}


def _inputs(seed, B, S, H, KV, Dk, Dv, dtype):
    """The same q, k, v for both frameworks: normal draws from numpy,
    rounded to ``dtype`` by JAX and carried to torch exactly (through f32,
    which holds every bf16 value)."""
    rng = np.random.default_rng(seed)
    jt = getattr(jnp, dtype)
    js = [jnp.asarray(rng.normal(size=shape), jt)
          for shape in ((B, S, H, Dk), (B, S, KV, Dk), (B, S, KV, Dv))]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          for a in js]
    return js, ts


def _err(t, j):
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j, np.float32))))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 128, 4, 4, 64),
    (1, 256, 8, 2, 64),
    (2, 256, 4, 1, 128),
])
def test_plain_version_matches_pallas_kernel(B, S, H, KV, D, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(hash((B, S, H, KV, D)) % 2**31, B, S,
                                      H, KV, D, D, dtype)
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, causal=causal)
    assert out.shape == (B, S, H, D) and out.dtype == q.dtype
    kern = j_flash(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                   interpret=True)
    ref = j_ref(jq, jk, jv, causal=causal)
    assert _err(out, kern) < TOL[dtype]
    assert _err(out, ref) < TOL[dtype]
    assert fa.launches == before          # the plain version is not counted


@pytest.mark.parametrize("schedule", ["rect", "triangle"])
@pytest.mark.parametrize("dtype,B,S,H,KV,Dk,Dv", [
    ("float32", 2, 77, 4, 2, 16, 16),     # ragged S
    ("float32", 1, 96, 6, 2, 64, 64),     # G=3, triangle blocks of 16
    ("float32", 2, 33, 4, 4, 24, 16),     # reduced MLA dims, ragged
    ("float32", 1, 64, 5, 5, 96, 64),     # MLA head dims, 5 heads
    ("float32", 2, 1, 4, 2, 16, 16),      # S = 1
    ("bfloat16", 2, 77, 6, 2, 96, 64),    # bf16, ragged, Dk != Dv
])
def test_ragged_and_mla_dims_match_causal_attention(dtype, B, S, H, KV, Dk,
                                                    Dv, schedule):
    (jq, jk, jv), (q, k, v) = _inputs(S * 1000 + Dk, B, S, H, KV, Dk, Dv,
                                      dtype)
    scale = Dk ** -0.5
    ctx = AxisCtx(attn_schedule=schedule, attn_chunk=32)
    ref = j_causal(jq, jk, jv, ctx, scale=scale)
    out = fa.flash_attention(q, k, v, causal=True, scale=scale)
    assert out.shape == (B, S, H, Dv)
    assert _err(out, ref) < TOL[dtype]
    # the default scale is taken from Dk, as the reference's is from q
    assert torch.equal(fa.flash_attention(q, k, v), out)


def test_plain_version_masks_the_future():
    """Changing keys and values at positions after i leaves row i alone."""
    _, (q, k, v) = _inputs(7, 1, 40, 4, 2, 64, 64, "float32")
    out = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] += 1.0
    v2[:, 20:] -= 1.0
    out2 = fa.flash_attention(q, k2, v2)
    assert torch.equal(out[:, :20], out2[:, :20])
    assert not torch.equal(out[:, 20:], out2[:, 20:])


@pytest.mark.parametrize("Dk,Dv", sorted(fa.HEAD_DIMS))
def test_tensor_map_check_takes_every_head_dim_pair(Dk, Dv):
    """The bf16 kernel's tensor-map limits (``_check_tma``, which the
    wrapper applies to bf16 CUDA calls) admit every pair it is built for."""
    q = torch.zeros(2, 77, 6, Dk, dtype=torch.bfloat16)
    k = torch.zeros(2, 77, 2, Dk, dtype=torch.bfloat16)
    fa._check_tma(q, k, torch.zeros(2, 77, 2, Dv, dtype=torch.bfloat16))


@pytest.mark.parametrize("D", [4, 12, 256])
def test_tensor_map_check_rejects_what_a_tensor_map_cannot_take(D):
    """Byte strides that are not multiples of 16 (D of 4 or 12) and head
    dims past three 64-wide panels raise ``ValueError``."""
    t = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa._check_tma(t, t, t)
