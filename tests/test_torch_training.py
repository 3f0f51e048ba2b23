"""The port's training substrate (repro_torch.training, repro_torch.data,
``Model.loss``, ``launch/steps.py`` ``make_train_step``,
``launch/train.py``) on the CPU: every case of ``tests/test_training.py``
on torch, then parity with the JAX package on the same numpy inputs:
AdamW and Adafactor over 5 steps, ``compress_grads``, ``PackedLoader``
batches bitwise, checkpoints written by either package restored by the
other, reduced tinyllama's ``Model.loss`` and every gradient against
``jax.value_and_grad(model.loss)`` (weights carried by
``params_from_numpy``), ``make_accum_train_step`` with accum 2 and
compression over 3 steps, remat on against off, and the training entry
point's restart drill.

Tolerances (f32): optimizer states and parameters 1e-6 after 5 steps
(``b ** t`` and the sqrt / divisions may round differently in the two
frameworks; the differences measure 0 for AdamW, 6.0e-8 for Adafactor);
the loss 1e-5 and
every gradient 1e-6 (reductions in other orders; they measure 4.8e-7 and
5.4e-8, for gradients up to 0.12); the model's parameters after one
AdamW step at lr 1e-3 within 1e-5, lr / 100 (the first update is about
g / |g|, so where |g| is near 2.5e-5 a 5e-8 difference in g moves it by
2e-3; the largest difference measures 2.1e-6); the accumulated, compressed
training's losses 1e-5 (they measure 4.8e-7).  bf16 (reduced tinyllama
with bf16 weights, as the card's main path): every gradient within two
bf16 ulps (2^-7) of its leaf's largest value (gradients are stored in
bf16 and the two frameworks' bf16 products round apart; they measure
5.3e-3), the losses over 6 AdamW steps within 1e-3 (they measure
2.5e-4)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import PackedLoader as JPackedLoader  # noqa: E402
from repro.launch.train import \
    make_accum_train_step as j_accum_step  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.training import checkpoint as j_ckpt  # noqa: E402
from repro.training import compression as j_comp  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, PackedLoader,  # noqa: E402
                                       device_batches)
from repro_torch.launch.steps import (make_train_step,  # noqa: E402
                                      value_and_grad)
from repro_torch.launch.train import make_accum_train_step  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tree_leaves, tree_map)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.compression import (  # noqa: E402
    compress_grads, compressed_bytes_ratio, dequantize_int8,
    init_error_feedback, quantize_int8)
from repro_torch.training.fault_tolerance import (  # noqa: E402
    StragglerMonitor, TrainSupervisor)
from repro_torch.training.optimizer import adafactor, adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STATE_ATOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
STEP_ATOL = 1e-5
BF16_GRAD_RTOL = 2 ** -7
BF16_LOSS_ATOL = 1e-3
ARCH = "tinyllama-1.1b"


def _quad_problem():
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8)), "b": torch.zeros((8,))}

    def loss_fn(p):
        return ((p["w"] - target) ** 2).sum() + (p["b"] ** 2).sum()
    return params, loss_fn


def _grad(loss_fn, params):
    return value_and_grad(lambda p: loss_fn(p), params)[1]


# ---------------------------------------------------------------------------
# the reference's cases, on torch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [lambda: adamw(1e-1),
                                  lambda: adafactor(1e-1)])
def test_optimizers_descend(make):
    opt = make()
    params, loss_fn = _quad_problem()
    state = opt.init(params)
    l0 = float(loss_fn(params))
    for _ in range(60):
        params, state = opt.update(params, _grad(loss_fn, params), state)
    assert float(loss_fn(params)) < 0.2 * l0


def test_adafactor_factored_state_shapes():
    opt = adafactor()
    params = {"m": torch.zeros((12, 6)), "v1": torch.zeros((5,))}
    st = opt.init(params)
    assert st["stats"]["m"]["vr"].shape == (12,)
    assert st["stats"]["m"]["vc"].shape == (6,)
    assert st["stats"]["v1"]["v"].shape == (5,)


def test_checkpoint_roundtrip_and_keep(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    params = {"a": torch.arange(6.0).reshape(2, 3),
              "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    for s in (10, 20, 30):
        cm.save(s, params)
    assert cm.all_steps() == [20, 30]            # keep-k GC
    got, _, meta = cm.restore(30, params)
    assert torch.equal(got["a"], params["a"])
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert meta["step"] == 30
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restart_continuity_exact(tmp_path):
    """fail-at-k then restore must produce the exact same trajectory as an
    uninterrupted run (deterministic indexed batches); ``update`` is
    functional, so both runs start from the same initial tensors."""
    opt = adamw(5e-2)
    params, loss_fn = _quad_problem()

    def step_fn(p, s, batch):
        scale = batch["scale"]
        g = _grad(lambda q: scale * loss_fn(q), p)
        p, s = opt.update(p, g, s)
        return p, s, scale * loss_fn(p)

    def make_batches(start):
        def gen():
            i = start
            while True:
                yield {"scale": torch.tensor(1.0 + 0.01 * i)}
                i += 1
        return gen()

    def run(fail):
        cm = CheckpointManager(str(tmp_path / f"f{fail}"), keep=3)
        sup = TrainSupervisor(step_fn, cm, ckpt_every=5)
        return sup.run_with_recovery(params, opt.init(params), make_batches,
                                     n_steps=23, fail_at_step=fail)

    clean = run(None)
    failed = run(17)
    assert failed["restarts"] == 1
    assert torch.equal(params["w"], torch.zeros((8, 8)))   # left unchanged
    np.testing.assert_allclose(clean["params"]["w"].numpy(),
                               failed["params"]["w"].numpy(), rtol=1e-6)


def test_restore_onto_like_device_and_no_mesh(tmp_path):
    """The port's counterpart of the reference's elastic restore: leaves
    restore onto ``params_like``'s device and dtype; the port has no mesh,
    so a sharding that is not a ``RankShard`` (a rank's place in a
    tensor-parallel group, ``tests/test_torch_tp.py``) is refused."""
    cm = CheckpointManager(str(tmp_path), keep=1)
    params = {"w": torch.arange(16.0).reshape(4, 4)}
    cm.save(5, params)
    like = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    got, _, _ = cm.restore(5, like)
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].device == like["w"].device
    assert torch.equal(got["w"].float(), params["w"])
    with pytest.raises(TypeError, match="RankShard"):
        cm.restore(5, params, param_shardings={"w": None})


def test_quantize_roundtrip_bounds():
    x = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(64,)) * 3).astype(np.float32))
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6
    assert compressed_bytes_ratio() == 0.5
    assert compressed_bytes_ratio(torch.float32) == 0.25


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(1)
    g_true = [torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
              for _ in range(50)]
    ef = init_error_feedback({"g": g_true[0]})
    acc_q = torch.zeros((32,))
    acc_t = torch.zeros((32,))
    for g in g_true:
        dq, ef = compress_grads({"g": g}, ef)
        acc_q = acc_q + dq["g"]
        acc_t = acc_t + g
    # error feedback keeps the cumulative compressed sum near the true sum
    resid = float((acc_q - acc_t).abs().max())
    scale = float(acc_t.abs().max()) + 1e-6
    assert resid / scale < 0.05


def test_compressed_training_still_learns():
    opt = adamw(5e-2)
    params, loss_fn = _quad_problem()
    state = opt.init(params)
    ef = init_error_feedback(params)
    l0 = float(loss_fn(params))
    for _ in range(80):
        g, ef = compress_grads(_grad(loss_fn, params), ef)
        params, state = opt.update(params, g, state)
    assert float(loss_fn(params)) < 0.3 * l0


def test_data_pipeline_shapes_and_shards():
    cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=8)
    it0 = iter(PackedLoader(cfg, shard_index=0, num_shards=2))
    it1 = iter(PackedLoader(cfg, shard_index=1, num_shards=2))
    b0, b1 = next(it0), next(it1)
    assert b0["tokens"].shape == (4, 32)
    assert b0["labels"].shape == (4, 32)
    assert not np.array_equal(b0["tokens"], b1["tokens"])  # disjoint shards
    assert b0["tokens"].max() < 512
    again = next(iter(PackedLoader(cfg, shard_index=0, num_shards=2)))
    np.testing.assert_array_equal(b0["tokens"], again["tokens"])
    dev = next(device_batches(PackedLoader(cfg), "cpu"))
    assert dev["tokens"].dtype == torch.int32
    assert tuple(dev["labels"].shape) == (8, 32)


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(20):
        mon.observe(i, 0.01)
    mon.observe(20, 0.2)
    assert 20 in mon.flagged


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "nested": {"m": rng.normal(size=(3, 4, 5)).astype(np.float32),
                       "one": rng.normal(size=(6, 1)).astype(np.float32)}}


def _close(t_tree, j_tree, atol, rtol=0.0):
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.float().numpy() if isinstance(t, torch.Tensor) else t,
        np.asarray(j, np.float32), rtol=rtol, atol=atol), t_tree, j_tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_over_5_steps(name):
    make = {"adamw": lambda m: m.adamw(1e-2, weight_decay=0.1),
            "adafactor": lambda m: m.adafactor(1e-2)}[name]
    import repro_torch.training.optimizer as t_opt
    topt, jopt = make(t_opt), make(j_opt)
    p0 = _np_tree(0)
    tp, jp = params_from_numpy(p0, "cpu"), jax.tree.map(jnp.asarray, p0)
    ts, js = topt.init(tp), jopt.init(jp)
    for i in range(5):
        g = _np_tree(10 + i)
        tp, ts = topt.update(tp, params_from_numpy(g, "cpu"), ts)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
    _close(tp, jp, STATE_ATOL)
    _close(ts, js, STATE_ATOL)
    assert int(ts["step"]) == int(js["step"]) == 5


def test_compress_grads_matches_reference():
    g, e = _np_tree(3), _np_tree(4)
    g = tree_map(lambda a: a * 5.0, g)
    tg, te = compress_grads(params_from_numpy(g, "cpu"),
                            params_from_numpy(e, "cpu"))
    jg, je = j_comp.compress_grads(jax.tree.map(jnp.asarray, g),
                                   jax.tree.map(jnp.asarray, e))
    _close(tg, jg, 0.0)
    _close(te, je, 0.0)


def test_packed_loader_batches_bitwise_reference():
    for shard in (0, 1):
        args = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
        ti = iter(PackedLoader(DataConfig(**args), shard, 2))
        ji = iter(JPackedLoader(JDataConfig(**args), shard, 2))
        for _ in range(4):
            tb, jb = next(ti), next(ji)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])


def _j_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """Params (f32 and bf16) and an optimizer state (with its int32 step)
    written by one package restore in the other, bit for bit."""
    rng = np.random.default_rng(7)
    params = {"prefix": {"l0": {"wq": rng.normal(size=(4, 2, 3))}},
              "units": {"l0": {"ln1": rng.normal(size=(2, 4))}},
              "final_norm": rng.normal(size=(4,))}
    params = tree_map(lambda a: a.astype(np.float32), params)
    tp = params_from_numpy(params, "cpu")
    tp["units"]["l0"]["ln1"] = tp["units"]["l0"]["ln1"].bfloat16()
    jp = _j_tree(params)
    jp["units"]["l0"]["ln1"] = jp["units"]["l0"]["ln1"].astype(jnp.bfloat16)
    topt, jopt = adamw().init(tp), j_opt.adamw().init(jp)
    topt["step"] += 3
    jopt["step"] += 3
    if writer == "jax":
        j_ckpt.CheckpointManager(str(tmp_path)).save(3, jp, jopt)
        got, opt, meta = CheckpointManager(str(tmp_path)).restore(
            3, tree_map(torch.zeros_like, tp),
            tree_map(torch.zeros_like, topt))
        want, want_opt = tp, topt
    else:
        CheckpointManager(str(tmp_path)).save(3, tp, topt)
        got, opt, meta = j_ckpt.CheckpointManager(str(tmp_path)).restore(
            3, jax.tree.map(jnp.zeros_like, jp),
            jax.tree.map(jnp.zeros_like, jopt))
        want, want_opt = jp, jopt
    assert meta["step"] == 3
    for g, w in ((got, want), (opt, want_opt)):
        gl = (tree_leaves(g) if writer == "jax"
              else [np.asarray(x) for x in jax.tree.leaves(g)])
        wl = (tree_leaves(w) if writer == "jax"
              else [np.asarray(x) for x in jax.tree.leaves(w)])
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype
            if writer == "jax":
                assert torch.equal(a, b)
            else:
                np.testing.assert_array_equal(a, b)


def _models(arch=ARCH, remat=False, dtype="float32"):
    jm = j_build(dataclasses.replace(j_reduced(arch), dtype=dtype,
                                     remat=remat))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(reduced_config(arch), remat=remat,
                                         dtype=dtype))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _batch(V, seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, V, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_loss_and_grads_match_reference():
    """Reduced tinyllama: ``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad(model.loss)`` on the same weights and batch."""
    jm, jp, tm, tp = _models()
    batch = _batch(tm.cfg.vocab_size)
    jl, jg = jax.value_and_grad(jm.loss)(jp, _j_tree(batch))
    tl, tg = value_and_grad(tm.loss, tp, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.ndim == 0
    assert abs(float(tl) - float(jl)) < LOSS_ATOL
    _close(tg, jg, GRAD_ATOL)
    assert all(bool(g.abs().sum() > 0) for g in tree_leaves(tg))


def test_make_train_step_matches_reference_step():
    """One ``make_train_step`` step (AdamW) against the reference's loss,
    gradient and update on the same weights; the params passed in are left
    unchanged."""
    jm, jp, tm, tp = _models()
    model, opt, step = make_train_step(tm.cfg, lr=1e-3)
    batch = _batch(tm.cfg.vocab_size, seed=1)
    before = tree_map(torch.clone, tp)
    new_p, state, loss = step(tp, opt.init(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    jl, jg = jax.value_and_grad(jm.loss)(jp, _j_tree(batch))
    jopt = j_opt.adamw(1e-3)
    jnew, _ = jopt.update(jp, jg, jopt.init(jp))
    assert abs(float(loss) - float(jl)) < LOSS_ATOL
    _close(new_p, jnew, STEP_ATOL)
    assert int(state["step"]) == 1
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("params changed"),
             tp, before)


def test_accum_compressed_steps_match_reference():
    """``make_accum_train_step`` with accum 2 and int8 compression: the
    losses of 3 steps on the same weights and ``PackedLoader`` batches
    match the reference's."""
    jm, jp, tm, tp = _models()
    cfg = tm.cfg
    topt, jopt = adamw(3e-3), j_opt.adamw(3e-3)
    tstep = make_accum_train_step(tm, topt, accum=2, compress=True)
    jstep = jax.jit(j_accum_step(jm, jopt, accum=2, compress=True))
    tstate = (topt.init(tp), init_error_feedback(tp))
    jstate = (jopt.init(jp), j_comp.init_error_feedback(jp))
    loader = iter(PackedLoader(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=16, global_batch=4)))
    tl, jl = [], []
    for _ in range(3):
        b = next(loader)
        tp, tstate, loss = tstep(tp, tstate, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        jp, jstate, jloss = jstep(jp, jstate, _j_tree(b))
        tl.append(float(loss))
        jl.append(float(jloss))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert tl[-1] < tl[0]


def test_bf16_training_matches_reference():
    """Reduced tinyllama in bf16 with remat, the main path's types: the
    loss and every gradient against ``jax.value_and_grad``, then 6 AdamW
    steps through ``make_accum_train_step`` against the reference's on the
    same ``PackedLoader`` batches."""
    jm, jp, tm, tp = _models(remat=True, dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    loader = iter(PackedLoader(DataConfig(vocab_size=tm.cfg.vocab_size,
                                          seq_len=32, global_batch=4)))
    batches = [next(loader) for _ in range(6)]
    jl, jg = jax.value_and_grad(jm.loss)(jp, _j_tree(batches[0]))
    tl, tg = value_and_grad(tm.loss, tp, {
        k: torch.from_numpy(v) for k, v in batches[0].items()})
    assert abs(float(tl) - float(jl)) < BF16_LOSS_ATOL
    for t, j in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        assert t.dtype == torch.bfloat16
        j = np.asarray(j, np.float32)
        assert (np.abs(t.float().numpy() - j).max()
                <= BF16_GRAD_RTOL * np.abs(j).max())
    topt, jopt = adamw(3e-3), j_opt.adamw(3e-3)
    tstep = make_accum_train_step(tm, topt)
    jstep = jax.jit(j_accum_step(jm, jopt))
    tstate, jstate = (topt.init(tp), None), (jopt.init(jp), None)
    tls, jls = [], []
    for b in batches:
        tp, tstate, loss = tstep(tp, tstate, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        jp, jstate, jloss = jstep(jp, jstate, _j_tree(b))
        tls.append(float(loss))
        jls.append(float(jloss))
    np.testing.assert_allclose(tls, jls, rtol=0, atol=BF16_LOSS_ATOL)
    assert tls[-1] < tls[0]


def test_remat_grads_equal_no_remat():
    """``cfg.remat`` checkpoints every unit (its forward reruns in the
    backward); the loss and gradients are bitwise those without it."""
    _, _, tm, tp = _models()
    rm = build_model(dataclasses.replace(tm.cfg, remat=True))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tm.cfg.vocab_size, seed=2).items()}
    l0, g0 = value_and_grad(tm.loss, tp, batch)
    l1, g1 = value_and_grad(rm.loss, tp, batch)
    assert torch.equal(l0, l1)
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail(
        "remat changed a gradient"), g0, g1)


def test_train_entry_point_restarts_once(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu`` with an
    injected failure: one restart from the last checkpoint, the loss falls,
    ``TRAIN OK``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
         "--ckpt-every", "5", "--fail-at", "7", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "restarts=1" in out.stdout and "steps=12" in out.stdout
    assert out.stdout.strip().endswith("TRAIN OK")
    meta = json.loads((tmp_path / "step_00000010" / "meta.json").read_text())
    assert meta["step"] == 10


def test_train_lm_example_runs(tmp_path, capsys):
    """``python -m repro_torch.examples.train_lm --device cpu``, 2 steps of
    lm-30m (its failure at step 60 is not reached): the loss falls."""
    from repro_torch.examples import train_lm
    train_lm.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert "steps=2 restarts=0" in out
    assert out.strip().endswith("TRAIN EXAMPLE OK")
