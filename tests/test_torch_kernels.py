"""Plain versions of the port's paged-attention kernels
(repro_torch.kernels.paged_attention; on CPU tensors the wrappers take
them) against the JAX package's Pallas kernels run in interpret mode and
its jnp helpers: same numpy inputs, outputs allclose at f32 1e-5, page
pools equal (off the scrap page where the Pallas kernel parks
write-backs)."""

import pytest

torch = pytest.importorskip("torch")

try:  # noqa: E402
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_fallback import given, settings, strategies as st

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    fused_decode_attention as j_fused, paged_attention as j_paged,
    paged_gather as j_gather, paged_kv_append as j_append,
    paged_kv_append_batch as j_append_batch)
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("B,H,KV,D,nmax", [
    (2, 4, 4, 64, 2),       # MHA (G=1)
    (4, 8, 2, 64, 4),       # GQA G=4
    (2, 8, 8, 128, 3),      # MHA wide head
    (2, 4, 1, 64, 2),       # MQA (KV=1, G=4)
    (1, 6, 3, 64, 3),       # GQA G=2, non-pow2 heads
    (2, 16, 4, 16, 2),      # GQA G=4, small head_dim (reduced configs)
])
def test_paged_attention_matches_pallas(B, H, KV, D, nmax):
    page, P = 128, 16
    rng = np.random.default_rng(hash((B, H, KV, D, nmax)) % 2**31)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    tables = np.stack([rng.choice(P, size=nmax, replace=False)
                       for _ in range(B)]).astype(np.int32)
    ctx = rng.integers(1, nmax * page + 1, size=(B,)).astype(np.int32)
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(tables), jnp.asarray(ctx), interpret=True)
    got = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    ref = tpa.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(tables), _t(ctx))
    assert torch.equal(ref, got)          # the CPU wrapper IS the plain path


@settings(max_examples=12, deadline=None)
@given(B=st.integers(1, 3), n_max=st.integers(1, 3),
       page=st.sampled_from([4, 8]), KV=st.sampled_from([1, 2]),
       G=st.sampled_from([1, 2]), seed=st.integers(0, 10**6))
def test_fused_decode_matches_pallas(B, n_max, page, KV, G, seed):
    D = 4
    H = KV * G
    P = B * n_max + 1                       # +1: scrap page at P-1
    rng = np.random.default_rng(seed)
    k_pages = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    v_pages = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k_new = rng.normal(size=(B, KV, D)).astype(np.float32)
    v_new = rng.normal(size=(B, KV, D)).astype(np.float32)
    tables = np.arange(B * n_max, dtype=np.int32).reshape(B, n_max)
    pos = rng.integers(0, n_max * page, size=B).astype(np.int32)

    o_j, kj, vj = j_fused(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(tables),
        jnp.asarray(pos), interpret=True)
    o_t, kt, vt = tpa.fused_decode_attention(
        _t(q), _t(k_new), _t(v_new), _t(k_pages), _t(v_pages), _t(tables),
        _t(pos))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(kt.numpy()[:-1], np.asarray(kj)[:-1])
    np.testing.assert_array_equal(vt.numpy()[:-1], np.asarray(vj)[:-1])


def test_paged_kv_append_chunk_matches_jnp():
    """Uneven, page-crossing prefill chunks with padded rows routed to the
    scrap page: the pools and the gathered sequence equal the reference."""
    page, P, KV, D, pad = 16, 8, 2, 32, 32
    rng = np.random.default_rng(3)
    seq = rng.normal(size=(2, 41, KV, D)).astype(np.float32)
    table = np.asarray([5, 2, 7], np.int32)
    kj = vj = jnp.zeros((P + 1, page, KV, D), jnp.float32)
    kt = torch.zeros(P + 1, page, KV, D)
    vt = torch.zeros(P + 1, page, KV, D)
    start = 0
    for chunk in (7, 16, 18):
        kc = np.zeros((pad, KV, D), np.float32)
        vc = np.zeros((pad, KV, D), np.float32)
        kc[:chunk] = seq[0, start:start + chunk]
        vc[:chunk] = seq[1, start:start + chunk]
        kj, vj = j_append(kj, vj, jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(table), start, n=jnp.int32(chunk))
        kt, vt = tpa.paged_kv_append(kt, vt, _t(kc), _t(vc), _t(table),
                                     start, n=chunk)
        start += chunk
    np.testing.assert_array_equal(kt.numpy()[:-1], np.asarray(kj)[:-1])
    np.testing.assert_array_equal(vt.numpy()[:-1], np.asarray(vj)[:-1])
    got = tpa.paged_gather(kt, _t(table))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_gather(kj, jnp.asarray(table))))
    np.testing.assert_array_equal(got.numpy()[:41], seq[0])


def test_paged_kv_append_batch_matches_jnp():
    page, P, KV, D = 16, 6, 2, 32
    rng = np.random.default_rng(4)
    kp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
    tables = np.asarray([[0, 1], [3, 2]], np.int32)
    positions = np.asarray([17, 3], np.int32)
    k1 = rng.normal(size=(2, KV, D)).astype(np.float32)
    v1 = rng.normal(size=(2, KV, D)).astype(np.float32)
    kj, vj = j_append_batch(*map(jnp.asarray, (kp, vp, k1, v1, tables,
                                               positions)))
    kt, vt = tpa.paged_kv_append_batch(*map(_t, (kp, vp, k1, v1, tables,
                                                 positions)))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_fused_ref_is_append_then_attend():
    """The plain fused version equals the two-dispatch pair exactly."""
    rng = np.random.default_rng(5)
    B, H, KV, D, page, n_max = 3, 8, 2, 16, 8, 3
    P = B * n_max + 1
    kp = torch.tensor(rng.normal(size=(P, page, KV, D)).astype(np.float32))
    vp = torch.tensor(rng.normal(size=(P, page, KV, D)).astype(np.float32))
    q = torch.tensor(rng.normal(size=(B, H, D)).astype(np.float32))
    kn = torch.tensor(rng.normal(size=(B, KV, D)).astype(np.float32))
    vn = torch.tensor(rng.normal(size=(B, KV, D)).astype(np.float32))
    tab = torch.arange(B * n_max, dtype=torch.int32).reshape(B, n_max)
    pos = torch.tensor([0, page - 1, page * n_max - 1], dtype=torch.int32)
    o1, k1, v1 = tpa.fused_decode_attention_ref(q, kn, vn, kp.clone(),
                                                vp.clone(), tab, pos)
    k2, v2 = tpa.paged_kv_append_batch(kp.clone(), vp.clone(), kn, vn, tab,
                                       pos)
    o2 = tpa.paged_attention(q, k2, v2, tab, pos + 1)
    assert torch.equal(o1, o2) and torch.equal(k1, k2) and torch.equal(v1, v2)
