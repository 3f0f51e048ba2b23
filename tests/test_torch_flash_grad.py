"""The gradient of the port's flash attention on the CPU, where
``FlashAttentionFn`` runs the plain versions: the plain backward
``flash_attention_bwd_ref`` (P recomputed from the forward's log-sum-exp)
against ``jax.vjp`` of the reference's attention (``kernels/ref.py``
``flash_attention_ref`` where Dk == Dv, ``causal_attention`` and, without
the causal mask, ``online_attention``, whose checkpointed chunk body is
what the reference trains through) at ragged S, every ``BWD_HEAD_DIMS``
pair, G 1 and 2, causal and full; ``FlashAttentionFn`` against torch
autograd through the plain forward; the head-dim pairs without a
backward refused; and ``bwd_error``, the bound the bf16 kernel is held
to, against the plain backward with P and dS rounded to bf16 as the
kernel rounds them (accepted) and against a dK without one query head's
terms or a dQ scaled by 1.01 (rejected).

Tolerances: f32 gradients within 2e-5 of the reference's (sums over up to
77 keys and 2 query heads taken in other orders; the errors measure 3.8e-6
at most); bf16 within 3e-2, about one bf16 ulp at these gradients'
magnitudes (up to 6, where an ulp is 3.1e-2; the gradients round to bf16
once, from f32 sums of bf16 inputs in both frameworks; the errors measure
1.6e-2 at most)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ref import flash_attention_ref as j_ref  # noqa: E402
from repro.models.attention import \
    causal_attention as j_causal  # noqa: E402
from repro.models.attention import \
    online_attention as j_online  # noqa: E402
from repro.models.partition import AxisCtx  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
B, S = 2, 77                      # S ragged against 32-key chunks


def _inputs(seed, S, H, KV, Dk, Dv, dtype):
    """q, k, v and the output's gradient, the same in both frameworks:
    numpy normal draws rounded to ``dtype`` by JAX, carried to torch
    exactly through f32."""
    rng = np.random.default_rng(seed)
    jt = getattr(jnp, dtype)
    js = [jnp.asarray(rng.normal(size=shape), jt)
          for shape in ((B, S, H, Dk), (B, S, KV, Dk), (B, S, KV, Dv),
                        (B, S, H, Dv))]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          for a in js]
    return js, ts


def _j_attention(causal, scale):
    """The reference's training attention, (B,S,H,Dk) x2 + (B,S,KV,Dv) ->
    (B,S,H,Dv)."""
    def f(q, k, v):
        if causal:
            return j_causal(q, k, v, AxisCtx(attn_chunk=32), scale=scale)
        H, KV, Dk, Dv = q.shape[2], k.shape[2], q.shape[3], v.shape[3]
        o = j_online(q.reshape(B, S, KV, H // KV, Dk), k, v, jnp.arange(S),
                     0, scale=scale, kv_chunk=32, causal=False)
        return o.reshape(B, S, H, Dv)
    return f


def _err(t, j):
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j, np.float32))))


def _plain_grads(q, k, v, do, causal, scale):
    o = fa.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    lse = fa.flash_attention_lse_ref(q, k, causal=causal, scale=scale)
    return fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                      scale=scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("Dk,Dv", sorted(fa.BWD_HEAD_DIMS))
def test_plain_backward_matches_jax_vjp(Dk, Dv, G, causal):
    KV = 2
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(Dk * 10 + G, S, KV * G, KV,
                                               Dk, Dv, "float32")
    scale = Dk ** -0.5
    got = _plain_grads(q, k, v, do, causal, scale)
    _, vjp = jax.vjp(_j_attention(causal, scale), jq, jk, jv)
    for t, j in zip(got, vjp(jdo)):
        assert t.dtype == torch.float32
        assert _err(t, j) < TOL["float32"]
    if Dk == Dv:
        _, vjp = jax.vjp(lambda a, b, c: j_ref(a, b, c, causal=causal,
                                               scale=scale), jq, jk, jv)
        for t, j in zip(got, vjp(jdo)):
            assert _err(t, j) < TOL["float32"]


@pytest.mark.parametrize("Dk,Dv", [(64, 64), (96, 64), (128, 128),
                                   (192, 128)])
def test_plain_backward_bf16_matches_jax_vjp(Dk, Dv):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(Dk, S, 4, 2, Dk, Dv,
                                               "bfloat16")
    scale = Dk ** -0.5
    got = _plain_grads(q, k, v, do, True, scale)
    # the reference's attention returns f32 (its online softmax's sums)
    _, vjp = jax.vjp(_j_attention(True, scale), jq, jk, jv)
    for t, j in zip(got, vjp(jdo.astype(jnp.float32))):
        assert t.dtype == torch.bfloat16
        assert _err(t, j) < TOL["bfloat16"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dk,Dv", sorted(fa.BWD_HEAD_DIMS))
def test_function_matches_autograd_through_plain_forward(Dk, Dv, causal):
    """``flash_attention`` with inputs that require grad goes through
    ``FlashAttentionFn``: its output is bitwise the no-grad call's, and its
    gradients equal torch autograd through ``flash_attention_ref``."""
    _, (q, k, v, do) = _inputs(Dk + 1, S, 4, 2, Dk, Dv, "float32")
    plain = fa.flash_attention(q, k, v, causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.equal(out.detach(), plain)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(
        fa.flash_attention_ref(*ref_leaves, causal=causal), ref_leaves, do)
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() < TOL["float32"]
    assert fa.launches == before          # plain versions are not counted


def test_grad_off_takes_the_forward_alone():
    """Without grad (or with no input that requires it) the call is the
    plain forward, with no autograd node."""
    _, (q, k, v, _) = _inputs(3, 9, 4, 2, 16, 16, "float32")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        out = fa.flash_attention(*leaves)
    assert out.grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is None


def test_lse_is_the_rows_logsumexp():
    _, (q, k, _, _) = _inputs(4, S, 4, 2, 64, 64, "float32")
    lse = fa.flash_attention_lse_ref(q, k, causal=True)
    s = torch.einsum("bqhd,bshd->bhqs", q,
                     k.repeat_interleave(2, dim=2)) * 64 ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    assert lse.shape == (B, 4, S)
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() < 1e-5


@pytest.mark.parametrize("Dk,Dv", [(96, 128), (128, 64), (64, 128)])
def test_pairs_without_a_backward_raise(Dk, Dv):
    q = torch.zeros(1, 5, 4, Dk, requires_grad=True)
    k = torch.zeros(1, 5, 2, Dk)
    v = torch.zeros(1, 5, 2, Dv)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention_bwd(q.detach(), k, v, torch.zeros(1, 5, 4, Dv),
                               torch.zeros(1, 4, 5), torch.zeros(1, 5, 4, Dv))
    # without grad the forward still takes them
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == (1, 5, 4, Dv)
    assert fa.launches == before


def _bound_case(Dk, Dv, causal, H=4, KV=2, S=96):
    """bf16 inputs; the forward's output and lse from the plain versions;
    (bf16 inputs, f32 copies, lse) for the backward."""
    _, ts = _inputs(Dk + Dv + causal, S, H, KV, Dk, Dv, "bfloat16")
    q, k, v, do = ts
    o = fa.flash_attention_ref(q, k, v, causal=causal)
    lse = fa.flash_attention_lse_ref(q, k, causal=causal)
    return (q, k, v, o, do), [t.float() for t in (q, k, v, o, do)], lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dk,Dv", [(64, 64), (128, 128), (192, 128)])
def test_bf16_bound_accepts_rounded_operands(Dk, Dv, causal):
    """The plain backward with P and dS rounded to bf16 before the three
    gradient products and its outputs rounded to bf16 (what the bf16
    kernel computes) is within ``bwd_error``'s bound of the plain backward in
    f32."""
    (q, k, v, o, do), (qf, kf, vf, of, dof), lse = _bound_case(Dk, Dv,
                                                               causal)
    got = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                     bf16_operands=True)
    ref = fa.flash_attention_bwd_ref(qf, kf, vf, of, lse, dof, causal=causal)
    rss = fa.flash_attention_bwd_rss(qf, kf, vf, of, lse, dof, causal=causal)
    for g, r, e in zip(got, ref, rss):
        assert g.dtype == torch.bfloat16 and r.dtype == torch.float32
        assert fa.bwd_error(g, r, e) <= 1
        # rounding P and dS moved the gradients: the bound is not idle
        assert not torch.equal(g, r.to(torch.bfloat16))


@pytest.mark.parametrize("Dk,Dv", [(64, 64), (192, 128)])
def test_bf16_bound_rejects_a_lost_head_and_a_scaled_dq(Dk, Dv):
    """A dK that lost one query head's terms (G = 2), and a dQ scaled by
    1.01, are outside ``bwd_error``'s bound."""
    (q, k, v, o, do), (qf, kf, vf, of, dof), lse = _bound_case(Dk, Dv, True)
    dq, dk, _ = fa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           bf16_operands=True)
    ref = fa.flash_attention_bwd_ref(qf, kf, vf, of, lse, dof)
    rss = fa.flash_attention_bwd_rss(qf, kf, vf, of, lse, dof)
    # query heads 2h of each kv-head h alone: G = 1 over the even heads
    lost = fa.flash_attention_bwd_ref(
        q[:, :, ::2].contiguous(), k, v, o[:, :, ::2].contiguous(),
        lse[:, ::2].contiguous(), do[:, :, ::2].contiguous(),
        bf16_operands=True)[1]
    assert fa.bwd_error(dk, ref[1], rss[1]) <= 1
    assert fa.bwd_error(lost, ref[1], rss[1]) > 1
    assert fa.bwd_error(dq, ref[0], rss[0]) <= 1
    assert fa.bwd_error((dq.float() * 1.01).to(torch.bfloat16), ref[0],
                        rss[0]) > 1
