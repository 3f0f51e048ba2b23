"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's ``repro.launch.roofline``.

``model_flops`` equals the reference's in all 40 (arch x shape) cells;
``roofline_terms`` picks the dominant term and the useful ratio on hand-made
records with the H100's constants (NVLink inside a node of 8, the NIC
beyond).  ``CostCounter``'s FLOPs of ``Model.logits`` and of one training
step of reduced configs are held against the reference's HLO walk
(``analyze_compiled`` of a one-device ``jax.jit``), op by op where the two
count differently:

- attention: the reference's online-softmax scan computes the full S x S
  rectangle (its ``rect`` schedule), the port's flash kernel reports the
  causal pairs S(S+1)/2 (its bound's formula; forward q.k and p.v, backward
  five products).  Each side's attention is measured alone (the reference's
  ``causal_attention`` compiled at the layer's shapes) and must equal its
  analytic formula;
- MoE: the reference's ``moe_dense`` combines through two dots (a one-hot
  einsum, 2 T k E, and the gated sum, 2 T E d), the port's by indexing;
  each side's MoE block is measured alone.

Everything else (projections, MLPs, experts, router, lm_head) must agree
within 1%.  The recurrent families are recorded, not asserted.
``roofline_decode_step`` on the CPU at the reference test's sizes: its
per-lane model FLOPs equal the reference's, its counted FLOPs per lane are
within 10% of the reference's interpret-mode record (attention over the
padding lanes), and its gauges are set."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.configs.shapes import get_shape as j_get_shape  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models.attention import causal_attention as j_causal  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.models.moe import moe_dense as j_moe_dense  # noqa: E402
from repro.models.partition import NULL_CTX as J_NULL  # noqa: E402

from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import all_cells, get_shape  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.moe import moe_dense  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402

CELLS = sorted((a, s) for a, s, _ in all_cells())
B, S = 2, 16


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert len(CELLS) == 40
    assert R.model_flops(get_config(arch), get_shape(shape)) == \
        JR.model_flops(j_get_config(arch), j_get_shape(shape))


def test_model_flops_conventions():
    cfg = get_config("tinyllama-1.1b")
    n = cfg.active_param_count()
    assert R.model_flops(cfg, get_shape("train_4k")) == 6.0 * n * 4096 * 256
    assert R.model_flops(cfg, get_shape("prefill_32k")) == \
        2.0 * n * 32768 * 32
    assert R.model_flops(cfg, get_shape("decode_32k")) == 2.0 * n * 128


def test_roofline_terms_and_dominance_h100():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.NET_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    rec = dict(chips=256, hlo_flops_per_chip=989e12,       # exactly 1 s
               hlo_bytes_per_chip=3.35e12 / 2,             # 0.5 s
               coll_bytes_per_chip=50e9 / 4,               # 0.25 s (NIC)
               model_flops=989e12 * 256 * 0.5)
    t = R.roofline_terms(rec)
    assert t["dominant"] == "compute"
    assert abs(t["t_compute_s"] - 1.0) < 1e-12
    assert abs(t["t_collective_s"] - 0.25) < 1e-12
    assert abs(t["useful_ratio"] - 0.5) < 1e-12
    assert abs(t["mfu_bound"] - 0.5) < 1e-12
    # memory-bound on the optimistic count
    t = R.roofline_terms(dict(rec, hlo_bytes_opt_per_chip=3.35e12 * 2))
    assert t["dominant"] == "memory" and t["roofline_s"] == 2.0
    assert abs(t["mfu_bound"] - 0.25) < 1e-12
    # collective-bound: a group beyond one node goes at the NIC's rate,
    # within a node at NVLink's
    rec_c = dict(rec, coll_bytes_per_chip=100e9, coll_group=16)
    t = R.roofline_terms(rec_c)
    assert t["dominant"] == "collective" and t["t_collective_s"] == 2.0
    t = R.roofline_terms(dict(rec_c, coll_group=8))
    assert t["dominant"] == "compute"
    assert abs(t["t_collective_s"] - 100e9 / 450e9) < 1e-12


def test_wire_bytes_ring_factors():
    assert R.wire_bytes("all-reduce", 8.0, 4) == 2.0 * 8 * 3 / 4
    assert R.wire_bytes("all-gather", 8.0, 4) == 8 * 3 / 4
    assert R.wire_bytes("reduce-scatter", 2.0, 4) == 2 * 3
    assert R.wire_bytes("all-to-all", 8.0, 4) == 8 * 3 / 4


# ---------------------------------------------------------------------------
# counted FLOPs vs the reference's HLO walk
# ---------------------------------------------------------------------------
def _hlo_flops(fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    return JR.analyze_compiled(text, chips=1)["hlo_flops_per_chip"]


def _counted(fn, *args) -> float:
    with R.CostCounter() as c:
        fn(*args)
    return c.flops


def _attn_dims(cfg):
    """(H, KV, Dk, Dv) of the full-sequence attention."""
    if cfg.kv_lora_rank:
        return (cfg.num_heads, cfg.num_heads, cfg.qk_nope_dim
                + cfg.qk_rope_dim, cfg.v_head_dim)
    return (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.resolved_head_dim)


def _layers(cfg, kind):
    pats = list(cfg.prefix_pattern) + list(cfg.unit_pattern) * cfg.num_units
    if kind == "attn":
        return sum(m in ("attn", "mla") for m, _ in pats)
    return sum(f == "moe" for _, f in pats)


def _ref_attention(cfg, train: bool) -> float:
    """The reference's ``causal_attention`` alone at the layer's shapes:
    forward, or forward and gradient."""
    H, KV, Dk, Dv = _attn_dims(cfg)
    q = jnp.ones((B, S, H, Dk), jnp.float32)
    k = jnp.ones((B, S, KV, Dk), jnp.float32)
    v = jnp.ones((B, S, KV, Dv), jnp.float32)

    def fwd(q, k, v):
        return j_causal(q, k, v, J_NULL, scale=0.1)

    if not train:
        return _hlo_flops(fwd, q, k, v)
    return _hlo_flops(jax.grad(lambda q, k, v: fwd(q, k, v).sum(),
                               argnums=(0, 1, 2)), q, k, v)


def _port_attention(cfg, train: bool) -> float:
    """The flash kernel's reported FLOPs: its bound's formula."""
    H, KV, Dk, Dv = _attn_dims(cfg)
    pairs = S * (S + 1) // 2
    fwd = 2 * B * H * (Dk + Dv) * pairs
    return fwd + (2 * B * H * (3 * Dk + 2 * Dv) * pairs if train else 0)


def _moe_params(cfg):
    g = torch.Generator().manual_seed(0)
    E, d, F = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    return {"router": torch.randn(d, E, generator=g),
            "w_gate": torch.randn(E, d, F, generator=g),
            "w_up": torch.randn(E, d, F, generator=g),
            "w_down": torch.randn(E, F, d, generator=g)}


def _moe_pair(cfg, train: bool):
    """(reference, port) FLOPs of one ``moe_dense`` block on B x S
    tokens."""
    p = _moe_params(cfg)
    x = torch.randn(B, S, cfg.d_model)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    jx = jnp.asarray(x.numpy())
    jcfg = j_reduced(cfg.name.replace("-smoke", ""))
    if train:
        ref = _hlo_flops(jax.grad(lambda x, p: j_moe_dense(x, p, jcfg).sum(),
                                  argnums=(0, 1)), jx, jp)
        leaves = [x] + list(p.values())
        for t in leaves:
            t.requires_grad_(True)
        port = _counted(lambda: torch.autograd.grad(
            moe_dense(x, p, cfg).sum(), leaves))
    else:
        ref = _hlo_flops(lambda x, p: j_moe_dense(x, p, jcfg), jx, jp)
        port = _counted(lambda: moe_dense(x, p, cfg))
    return ref, port


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return toks


ASSERTED = ["tinyllama-1.1b", "kimi-k2-1t-a32b", "minicpm3-4b",
            "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("train", [False, True], ids=["logits", "train"])
@pytest.mark.parametrize("arch", ASSERTED)
def test_counted_flops_match_the_hlo_walk(arch, train):
    cfg = reduced_config(arch)
    jcfg = j_reduced(arch)
    toks = _batch(cfg)
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks).long()}
    if train:
        jmodel, jopt, jstep = j_train_step(jcfg, J_NULL)
        ref = _hlo_flops(jstep, jparams, jopt.init(jparams), jbatch)
        _, opt, step = make_train_step(cfg)
        state = opt.init(params)
        port = _counted(step, params, state, batch)
    else:
        ref = _hlo_flops(jm.logits, jparams, jbatch)
        port = _counted(model.logits, params, batch)
    n_attn, n_moe = _layers(cfg, "attn"), _layers(cfg, "moe")
    # attention, op by op: each side's count equals its formula
    H, KV, Dk, Dv = _attn_dims(cfg)
    ref_attn = _ref_attention(cfg, train)
    rect = 2 * B * H * S * S * (Dk + Dv)
    assert ref_attn >= rect                   # the full rectangle, at least
    if not train:
        assert ref_attn == rect
    port_attn = _port_attention(cfg, train)
    with R.CostCounter() as c:
        q = torch.zeros(B, S, H, Dk, requires_grad=train)
        k = torch.zeros(B, S, KV, Dk, requires_grad=train)
        v = torch.zeros(B, S, KV, Dv, requires_grad=train)
        from repro_torch.kernels.flash_attention import flash_attention
        with torch.set_grad_enabled(train):
            o = flash_attention(q, k, v, causal=True, scale=0.1)
            if train:
                o.sum().backward()
    assert c.flops == port_attn
    ref_moe = port_moe = 0.0
    if n_moe:
        ref_moe, port_moe = _moe_pair(cfg, train)
        if not train:
            T, E, k_, d = B * S, cfg.num_experts, cfg.top_k, cfg.d_model
            assert ref_moe - port_moe == 2 * T * k_ * E + 2 * T * E * d
    rest_ref = ref - n_attn * ref_attn - n_moe * ref_moe
    rest_port = port - n_attn * port_attn - n_moe * port_moe
    assert rest_ref > 0
    assert abs(rest_port - rest_ref) <= 0.01 * ref, (
        arch, train, ref, port, rest_ref, rest_port)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b"])
def test_recurrent_counts_recorded(arch):
    """Recorded, not asserted: the mixers' scans count differently (the
    reference's while loops by trip count, the port's log-step scan and
    step loop by op)."""
    cfg = reduced_config(arch)
    toks = _batch(cfg)
    jm = j_build(j_reduced(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    ref = _hlo_flops(jm.logits, jparams, {"tokens": jnp.asarray(toks)})
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    port = _counted(model.logits, params,
                    {"tokens": torch.from_numpy(toks)})
    print(f"{arch}: logits FLOPs port {port:.6g}, reference {ref:.6g}, "
          f"ratio {port / ref:.4f}")
    assert port > 0 and ref > 0


# ---------------------------------------------------------------------------
# roofline_decode_step on the CPU
# ---------------------------------------------------------------------------
def test_roofline_decode_step_cpu_against_the_reference():
    reg = MetricsRegistry()
    kw = dict(batch=1, num_blocks=2, page=8, max_len=16, repeats=1)
    rec = R.roofline_decode_step(registry=reg, device="cpu", **kw)
    ref = JR.roofline_decode_step(**kw)
    lanes = rec["batch"]
    assert lanes == 64 and rec["live"] == 1 and ref["batch"] == 1
    assert rec["model_flops"] / lanes == ref["model_flops"] / ref["batch"]
    per_lane, ref_lane = rec["hlo_flops_per_chip"] / lanes, \
        ref["hlo_flops_per_chip"] / ref["batch"]
    assert abs(per_lane - ref_lane) <= 0.10 * ref_lane, (per_lane, ref_lane)
    assert not rec["hlo_opaque"]
    assert rec["kernel_reports"] == {"fused_decode_attention": 1}
    assert rec["measured_s"] > 0 and rec["roofline_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert reg.value_of("roofline_decode_measured_s", batch="64") \
        == rec["measured_s"]
    assert reg.value_of("roofline_decode_model_flops", batch="64") \
        == rec["model_flops"]


def test_roofline_decode_step_window_cpu():
    reg = MetricsRegistry()
    rec = R.roofline_decode_step(batch=2, num_blocks=4, page=8, max_len=16,
                                 repeats=1, registry=reg, steps=2,
                                 device="cpu")
    assert rec["multi_steps"] == 2
    assert rec["multi_measured_s_per_token"] == rec["multi_measured_s"] / 2
    assert rec["multi_speedup_per_token"] > 0
    # two decode forwards and the sampler: at least twice the one forward
    assert rec["multi_hlo_flops_per_chip"] >= 2 * rec["hlo_flops_per_chip"]
    assert reg.value_of("roofline_decode_multi_measured_s", batch="64") \
        == rec["multi_measured_s"]


def test_roofline_decode_step_asked_for_the_card_without_one_fails():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.roofline_decode_step(batch=1, num_blocks=2, page=8, max_len=16)


def test_counter_counts_views_as_nothing_and_matmuls_by_formula():
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    with R.CostCounter() as c:
        a.t().reshape(4, 3)           # views move nothing
    assert c.flops == 0 and c.bytes == 0
    with R.CostCounter() as c:
        a @ b
    assert c.flops == 2 * 3 * 4 * 5
    assert c.bytes == 4 * (12 + 20 + 15) == c.bytes_opt


def test_counter_sees_kernel_launch_reports():
    """A wrapper reports its analytic cost; its plain version's ops are not
    counted again, and nothing launched unreported (not opaque)."""
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    with R.CostCounter() as c:
        fa.flash_attention(q, k, k)
    assert c.flops == 2 * 1 * 2 * 32 * (8 * 9 // 2)
    assert c.kernels == {"flash_attention": 1} and not c.opaque


def test_counter_meta_tensors_track_live_bytes():
    with R.CostCounter(track_live=True) as c:
        x = torch.empty(1024, device="meta")
        y = x * 2
        del y
        z = x + 1
    assert c.peak_live >= 4096 and z.device.type == "meta"


def test_reduced_configs_equal_for_the_counted_archs():
    for arch in ASSERTED:
        a = dataclasses.asdict(reduced_config(arch))
        b = dataclasses.asdict(j_reduced(arch))
        assert a == b
