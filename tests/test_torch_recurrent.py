"""The port's recurrent mixers and modality frontends against the JAX
package, on the CPU: ``_blocked_scan`` (one block and 16 blocks),
``mamba_apply`` in train, prefill (the conv cache's padding branch at S = 2
< dc-1 among them) and decode, ``_mlstm_parallel`` over four key chunks,
``mlstm_apply`` / ``slstm_apply`` in every mode, ``sinusoidal_embedding``;
the reduced jamba (mamba + attn + MoE), xlstm (mLSTM + sLSTM), musicgen
(audio frames, sinusoidal positions) and pixtral (vision patches, the
loss masked to the text) through ``logits``, ``prefill`` and two
``decode_step``s on the JAX package's weights (``params_from_numpy``), the
JAX package's prefill caches carried into the port's ``decode_step``, in
bf16 too; ``input_specs`` of every architecture and shape cell; and
``launch/train.py --reduced`` on jamba and xlstm, with the training
steps' losses against the JAX package's.

Tolerances, each set above what it measures here (f32 unless named):
- layers: ``LAYER_ATOL`` + ``LAYER_RTOL`` 1e-5 (weights drawn at
  1/sqrt(fan-in), so outputs are O(1) and states reach 13); measured at
  most 1.3e-6 of max(|ref|, 1): the scans 4.8e-7 (the log-step scan rounds
  in another order than XLA's tree), mamba's ssm state 7.6e-6 at 10.7,
  the mLSTM parallel form 2.9e-6 at 9.7;
- models: logits ``LOGITS_ATOL`` 1e-4, as ``tests/test_torch_fullseq.py``
  (measured at most 2.1e-7), caches ``CACHE_ATOL`` / ``CACHE_RTOL`` 1e-5
  (at most 1.9e-6 absolute, on xLSTM's caches);
- bf16 logits ``BF16_LOGITS_ATOL`` 2e-2 (the two frameworks round bf16
  activations at other places; measured at most 4.0e-3) at the positions
  whose MoE routes are not near a tie (``_route_ties``);
- ``decode_step`` after ``prefill`` against ``logits``: the reference's
  rtol = atol = 2e-2 (``tests/test_models_smoke.py``; measured 8.9e-8).

Batches by frontend come from ``_torch_batches.numpy_batch``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import reduced_config as j_reduced  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.configs.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.launch.train import \
    make_accum_train_step as j_accum_step  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.models.partition import NULL_CTX  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.data.pipeline import DataConfig, PackedLoader  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import layers, mamba, xlstm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        tree_leaves, tree_map)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.optimizer import adamw  # noqa: E402
from _torch_batches import numpy_batch  # noqa: E402

JAMBA, XLSTM, MUSICGEN, PIXTRAL = ("jamba-v0.1-52b", "xlstm-1.3b",
                                   "musicgen-medium", "pixtral-12b")
FAMILIES = [JAMBA, XLSTM, MUSICGEN, PIXTRAL]
LAYER_ATOL = LAYER_RTOL = 1e-5
LOGITS_ATOL = 1e-4
CACHE_ATOL = CACHE_RTOL = 1e-5
BF16_LOGITS_ATOL = 2e-2
B, S = 2, 16


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=rtol,
                               atol=atol)


def _rng_params(shapes, seed):
    """Seeded numpy weights, each (..., fan_in, *out) at std
    1/sqrt(fan_in) unless given as (shape, std)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in shapes.items():
        shape, std = spec if isinstance(spec[0], tuple) else (spec, None)
        std = std if std is not None else shape[0] ** -0.5
        out[name] = (rng.normal(size=shape) * std).astype(np.float32)
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S_", [16, 48, 64])
def test_blocked_scan_matches_reference(S_):
    """S = 16: one block (S < 32); 48 and 64: 16 blocks of 3 and 4, the
    block aggregates scanned across blocks.  Against the reference and
    against the plain sequential recurrence."""
    rng = np.random.default_rng(S_)
    dA = rng.uniform(0.5, 1.0, size=(2, S_, 3, 4)).astype(np.float32)
    dBx = rng.normal(size=(2, S_, 3, 4)).astype(np.float32)
    got = mamba._blocked_scan(torch.from_numpy(dA), torch.from_numpy(dBx))
    ref = j_mamba._blocked_scan(jnp.asarray(dA), jnp.asarray(dBx), NULL_CTX)
    _close(got, ref, LAYER_ATOL, LAYER_RTOL)
    s, seq = np.zeros((2, 3, 4), np.float64), []
    for t in range(S_):
        s = dA[:, t] * s + dBx[:, t]
        seq.append(s)
    _close(got, np.stack(seq, axis=1), LAYER_ATOL, LAYER_RTOL)


def _mamba_setup(seed=0):
    cfg = reduced_config(JAMBA)
    d, di, ds, dc = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
                     cfg.mamba_d_conv)
    dtr = cfg.resolved_dt_rank
    p = _rng_params({"w_in": (d, 2 * di), "conv_w": ((dc, di), 0.5),
                     "conv_b": ((di,), 0.1),
                     "w_x": (di, dtr + 2 * ds), "w_dt": (dtr, di),
                     "dt_bias": ((di,), 0.5), "D": ((di,), 1.0),
                     "w_out": (di, d)}, seed)
    p["A_log"] = np.broadcast_to(np.log(np.arange(1, ds + 1, dtype=np.float32)),
                                 (di, ds)).copy()
    return cfg, p


@pytest.mark.parametrize("S_", [2, 16, 64])
def test_mamba_apply_matches_reference(S_):
    """Train and prefill outputs, the prefill cache (S = 2 < dc-1: the conv
    cache zero-padded on the left), then two decode steps from the JAX
    package's cache: outputs and caches, the port's written in place."""
    cfg, p = _mamba_setup(S_)
    x = np.random.default_rng(1).normal(size=(2, S_ + 2, cfg.d_model)) \
        .astype(np.float32)
    jp, tp = _j(p), _t(p)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    out, none = mamba.mamba_apply(tx[:, :S_], tp, cfg, "train")
    ref, _ = j_mamba.mamba_apply(jx[:, :S_], jp, cfg, NULL_CTX, "train")
    assert none is None
    _close(out, ref, LAYER_ATOL, LAYER_RTOL)
    out, tc = mamba.mamba_apply(tx[:, :S_], tp, cfg, "prefill")
    ref, jc = j_mamba.mamba_apply(jx[:, :S_], jp, cfg, NULL_CTX, "prefill")
    _close(out, ref, LAYER_ATOL, LAYER_RTOL)
    assert tc["conv"].shape == (2, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)
    tree_map(lambda t, j: _close(t, j, LAYER_ATOL, LAYER_RTOL), tc, jc)
    if S_ < cfg.mamba_d_conv - 1:
        assert not tc["conv"][:, :cfg.mamba_d_conv - 1 - S_].any()
    tc = _t(jax.tree.map(np.asarray, jc))
    for i in range(2):
        before = dict(tc)
        out, tc = mamba.mamba_apply(tx[:, S_ + i:S_ + i + 1], tp, cfg,
                                    "decode", cache=tc)
        ref, jc = j_mamba.mamba_apply(jx[:, S_ + i:S_ + i + 1], jp, cfg,
                                      NULL_CTX, "decode", cache=jc)
        assert all(tc[k] is before[k] for k in before)
        _close(out, ref, LAYER_ATOL, LAYER_RTOL)
        tree_map(lambda t, j: _close(t, j, LAYER_ATOL, LAYER_RTOL), tc, jc)


def _qkv_gates(seed, S_, H=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, S_, H, dh)).astype(np.float32)
               for _ in range(3))
    logi = rng.normal(size=(2, S_, H)).astype(np.float32)
    logf = np.array(jax.nn.log_sigmoid(
        rng.normal(size=(2, S_, H)).astype(np.float32) + 2.0))
    return q, k * dh ** -0.5, v, logi, logf


@pytest.mark.parametrize("chunk", [4, 1024])
def test_mlstm_parallel_matches_reference(chunk):
    """Chunk 4 at S = 16 (four key chunks merged online) and the default
    chunk (S itself), against the JAX function at the same chunk: h, a and
    m."""
    arrs = _qkv_gates(chunk, 16)
    got = xlstm._mlstm_parallel(*map(torch.from_numpy, arrs), chunk=chunk)
    ref = j_xlstm._mlstm_parallel(*map(jnp.asarray, arrs), chunk)
    for g, r in zip(got, ref):
        _close(g, r, LAYER_ATOL, LAYER_RTOL)


def _xlstm_setup(mixer, seed=0):
    cfg = reduced_config(XLSTM)
    d, H = cfg.d_model, cfg.xlstm_num_heads
    dh = d // H
    if mixer == "mlstm":
        shapes = {w: (d, H, dh) for w in ("w_q", "w_k", "w_v")}
        shapes.update(w_i=(d, H), w_f=(d, H), w_og=(d, d), w_down=(d, d))
    else:
        shapes = {w: (d, H, dh) for w in ("w_z", "w_i", "w_f", "w_o")}
        shapes.update({r: (dh, H, dh) for r in ("r_z", "r_i", "r_f", "r_o")})
    p = _rng_params(shapes, seed)
    for r in ("r_z", "r_i", "r_f", "r_o"):
        if r in p:
            p[r] = np.ascontiguousarray(p[r].transpose(1, 0, 2))
    return cfg, p


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
@pytest.mark.parametrize("S_", [1, 12])
def test_xlstm_apply_matches_reference(mixer, S_):
    """Train and prefill outputs and the prefill cache, then two decode
    steps from the JAX package's cache: outputs and caches, the port's
    written in place."""
    cfg, p = _xlstm_setup(mixer, S_)
    t_fn = getattr(xlstm, f"{mixer}_apply")
    j_fn = getattr(j_xlstm, f"{mixer}_apply")
    x = np.random.default_rng(2).normal(size=(2, S_ + 2, cfg.d_model)) \
        .astype(np.float32)
    jp, tp = _j(p), _t(p)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    out, none = t_fn(tx[:, :S_], tp, cfg, "train")
    ref, _ = j_fn(jx[:, :S_], jp, cfg, NULL_CTX, "train")
    assert none is None
    _close(out, ref, LAYER_ATOL, LAYER_RTOL)
    out, tc = t_fn(tx[:, :S_], tp, cfg, "prefill")
    ref, jc = j_fn(jx[:, :S_], jp, cfg, NULL_CTX, "prefill")
    _close(out, ref, LAYER_ATOL, LAYER_RTOL)
    tree_map(lambda t, j: _close(t, j, LAYER_ATOL, LAYER_RTOL), tc, jc)
    tc = _t(jax.tree.map(np.asarray, jc))
    for i in range(2):
        before = dict(tc)
        out, tc = t_fn(tx[:, S_ + i:S_ + i + 1], tp, cfg, "decode", cache=tc)
        ref, jc = j_fn(jx[:, S_ + i:S_ + i + 1], jp, cfg, NULL_CTX, "decode",
                       cache=jc)
        assert all(tc[k] is before[k] for k in before)
        _close(out, ref, LAYER_ATOL, LAYER_RTOL)
        tree_map(lambda t, j: _close(t, j, LAYER_ATOL, LAYER_RTOL), tc, jc)


@pytest.mark.parametrize("shape,d", [((16,), 64), ((2, 5), 1536),
                                     ((4096,), 1536)])
def test_sinusoidal_embedding_matches_reference(shape, d):
    """(S,) and (B, S) positions, up to 4095 (musicgen's width at
    prefill_32k's first positions): within 1e-6 (sin and cos of the same
    f32 angles in two libraries)."""
    pos = np.random.default_rng(d).integers(0, 4096, shape).astype(np.int32)
    if len(shape) == 1 and shape[0] == 16:
        pos = np.arange(16, dtype=np.int32)
    got = layers.sinusoidal_embedding(torch.from_numpy(pos), d)
    ref = j_layers.sinusoidal_embedding(jnp.asarray(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (d,)
    _close(got, ref, 1e-6)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def _decode_batch(tm, embed, n=2, seed=9):
    """(full batch of S positions, its first S - n positions as a prefill
    batch, the n decoded tokens (B, n)): the last n inputs are the decoded
    tokens (for audio frames, their embeddings), so ``logits`` and
    ``prefill`` + ``decode_step`` see the same input."""
    cfg = tm.cfg
    b = numpy_batch(tm, B, S, 0)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)
    if cfg.frontend == "audio_frames":
        b["frames"][:, S - n:] = np.asarray(embed, np.float32)[toks]
        pre = {"frames": b["frames"][:, :S - n]}
    else:
        b["tokens"][:, -n:] = toks
        pre = {k: v for k, v in b.items() if k != "labels"}
        pre["tokens"] = b["tokens"][:, :-n]
    return b, pre, toks


def _models(arch, dtype="float32"):
    jm = j_build(dataclasses.replace(j_reduced(arch), dtype=dtype))
    tm = build_model(dataclasses.replace(reduced_config(arch), dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, _t(jax.tree.map(np.asarray, jp))


def _grown(tm, caches, length):
    out = tm.init_caches(B, length, "cpu")
    tree_map(lambda z, c: z[tuple(slice(0, n) for n in c.shape)].copy_(c),
             out, caches)
    return out


def _j_grown(jm, caches, length):
    def grow(z, c):
        return z.at[tuple(slice(0, n) for n in c.shape)].set(c)
    return jax.tree.map(grow, jm.init_caches(B, length), caches)


def _caches_close(tc, jc):
    tree_map(lambda t, j: _close(t, j, CACHE_ATOL, CACHE_RTOL), tc, jc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_prefill_two_decode_steps_match_reference(arch):
    """``logits``, ``prefill`` of S-2 positions (logits and caches), then
    two ``decode_step``s (logits, caches written in place) against the JAX
    model on its weights; the port's decode logits also equal its own
    ``logits`` at S-2 and S-1 (the reference's teacher-forcing contract),
    so a recurrent state left stale after the first step shows."""
    jm, jp, tm, tp = _models(arch)
    b, pre, toks = _decode_batch(tm, jp["embed"])
    full = tm.logits(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert tuple(full.shape) == (B, S, tm.cfg.vocab_size)
    _close(full, jm.logits(jp, _j(b)), LOGITS_ATOL)
    lt, ct = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in pre.items()})
    lj, cj = jm.prefill(jp, _j(pre))
    _close(lt, lj, LOGITS_ATOL)
    _caches_close(ct, cj)
    ct, cj = _grown(tm, ct, S), _j_grown(jm, cj, S)
    leaves = tree_leaves(ct)
    for i in range(2):
        pos = S - 2 + i
        dt, ct2 = tm.decode_step(tp, ct, torch.from_numpy(toks[:, i:i + 1]),
                                 pos)
        dj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(pos))
        assert all(a is b for a, b in zip(tree_leaves(ct2), leaves))
        _close(dt, dj, LOGITS_ATOL)
        _caches_close(ct, cj)
        np.testing.assert_allclose(dt.numpy(), full[:, pos].numpy(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_jax_prefill_caches_carry_into_port_decode(arch):
    """The JAX package's prefill caches, moved across by
    ``params_from_numpy``, drive the port's ``decode_step`` for two tokens
    to the JAX model's logits."""
    jm, jp, tm, tp = _models(arch)
    _, pre, toks = _decode_batch(tm, jp["embed"])
    _, cj = jm.prefill(jp, _j(pre))
    cj = _j_grown(jm, cj, S)
    ct = _t(jax.tree.map(np.asarray, cj))
    for i in range(2):
        dj, cj = jm.decode_step(jp, cj, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(S - 2 + i))
        dt, ct = tm.decode_step(tp, ct, torch.from_numpy(toks[:, i:i + 1]),
                                torch.tensor(S - 2 + i))
        _close(dt, dj, LOGITS_ATOL)


def _route_ties(monkeypatch):
    """Record, for every MoE router call of the port, which tokens have
    their k-th and (k+1)-th router probabilities within 2^-9 (relative) of
    each other.  In bf16 the two frameworks' hidden states differ by a few
    ulps, which moves the router's probabilities by about 1e-4, so such a
    token may take another expert in the JAX model: reduced jamba in bf16
    has three on its batch, at relative gaps of 6.7e-4, 9.3e-4 and
    1.7e-3; the logits at the second (2.5e-4 absolute) then differ by
    2.5e-2, at the others by 3.3e-3 and 2.9e-3; the next smallest gap is
    3.2e-3.  Returns the list the flags (T,) bool are appended to."""
    from repro_torch.models import moe
    flags, route = [], moe._route

    def recorded(x2, router, top_k):
        probs = torch.softmax(x2.float() @ router.float(), dim=-1).sort(
            dim=-1, descending=True).values
        flags.append(probs[:, top_k - 1] - probs[:, top_k]
                     < 2.0 ** -9 * probs[:, top_k - 1])
        return route(x2, router, top_k)

    monkeypatch.setattr(moe, "_route", recorded)
    return flags


def _tied(flags, *shape):
    """The recorded flags since the last call, OR-ed over the MoE layers,
    as ``shape``; the list emptied."""
    out = torch.zeros(shape, dtype=torch.bool)
    for f in flags:
        out |= f.view(shape)
    flags.clear()
    return out.numpy()


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_logits_match_reference(arch, monkeypatch):
    """The serving dtype: the reduced model in bf16 with the JAX package's
    bf16 weights (mamba's dt_bias, A_log and D stay f32 on both sides):
    logits within ``BF16_LOGITS_ATOL``, and the decode step after prefill
    too, at every position whose MoE routes are not near a tie
    (``_route_ties``); at most one position in eight is near one."""
    jm, jp, tm, tp = _models(arch, "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    flags = _route_ties(monkeypatch)
    b, pre, toks = _decode_batch(tm, jp["embed"])
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    lt = tm.logits(tp, tb).float().numpy()
    tied = _tied(flags, B, S)
    lj = np.asarray(jm.logits(jp, _j(b)), np.float32)
    assert tied.sum() <= tied.size // 8
    _close(torch.from_numpy(lt[~tied]), lj[~tied], BF16_LOGITS_ATOL)
    _, ct = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in pre.items()})
    _, cj = jm.prefill(jp, _j(pre))
    prefill_tied = _tied(flags, B, S - 2).any(axis=1)
    dt, _ = tm.decode_step(tp, _grown(tm, ct, S),
                           torch.from_numpy(toks[:, :1]), S - 2)
    dj, _ = jm.decode_step(jp, _j_grown(jm, cj, S), jnp.asarray(toks[:, :1]),
                           jnp.int32(S - 2))
    rows = ~(prefill_tied | _tied(flags, B))
    _close(dt[torch.from_numpy(rows)], np.asarray(dj)[rows],
           BF16_LOGITS_ATOL)


def _meta_like(t, j):
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(j.shape), (t.shape, j.shape)
    assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_input_specs_match_reference(arch, shape):
    """Every architecture (all three frontends, every mixer's cache) at
    every shape cell of ``configs/shapes.py`` (train, prefill and decode
    kinds), full width: the same keys, shapes and dtypes as the
    reference's ``input_specs``, as ``meta`` tensors."""
    assert dataclasses.astuple(SHAPES[shape]) == dataclasses.astuple(
        J_SHAPES[shape])
    tm = build_model(get_config(arch))
    jm = j_build(j_get_config(arch))
    got = tm.input_specs(SHAPES[shape])
    ref = jm.input_specs(J_SHAPES[shape])
    assert sorted(got) == sorted(ref)
    tree_map(_meta_like, got, ref)


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_train_steps_match_reference(arch):
    """Three AdamW steps of ``make_accum_train_step`` on ``PackedLoader``
    batches against the JAX package's on the same weights: losses within
    1e-5, and the loss falls."""
    jm, jp, tm, tp = _models(arch)
    topt, jopt = adamw(3e-3), j_opt.adamw(3e-3)
    tstep = t_train.make_accum_train_step(tm, topt)
    jstep = jax.jit(j_accum_step(jm, jopt))
    tstate, jstate = (topt.init(tp), None), (jopt.init(jp), None)
    loader = iter(PackedLoader(DataConfig(vocab_size=tm.cfg.vocab_size,
                                          seq_len=32, global_batch=2)))
    tl, jl = [], []
    for _ in range(3):
        b = next(loader)
        tp, tstate, loss = tstep(tp, tstate, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        jp, jstate, jloss = jstep(jp, jstate, _j(b))
        tl.append(float(loss))
        jl.append(float(jloss))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_train_entry_point_runs_reduced(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ARCH --reduced --device
    cpu``: ``PackedLoader`` tokens through the recurrent stack, the loss
    falls, ``TRAIN OK``."""
    t_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                  "4", "--batch", "2", "--seq", "32", "--ckpt-dir",
                  str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "steps=4 restarts=0" in out
    assert out.strip().endswith("TRAIN OK")
