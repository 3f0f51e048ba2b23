"""Expert-parallel MoE in the port (``models.moe.moe_ep`` on ranks joined by
``serving.tp.run_grid``) against the reference's ``moe_ep`` (a
``shard_map`` over a 4-device CPU mesh with Auto axes, in a subprocess)
and against the port's plain version ``moe_ep_ref``.

Grids (data, model) = (1, 4) and (2, 2), CPU ranks; the three gather modes
('weights' in prefill, 'tokens' in decode under decode TP, 'none' where
d_model does not divide the FSDP axis); a capacity factor of 0.5 makes
tokens drop.  f32: the ranks' outputs equal the reference's within 1e-5,
their kept expert choices equal in number; ``moe_ep_ref`` equals the ranks
within 1e-6 with the same kept count (the ranks' GEMMs run at the ranks'
shapes in both)."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

import numpy as np  # noqa: E402

from repro_torch.configs.archs import reduced_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_local_mesh  # noqa: E402
from repro_torch.launch.sharding import make_ctx  # noqa: E402
from repro_torch.models.moe import (ep_shards, gather_mode,  # noqa: E402
                                    moe_apply, moe_dense, moe_ep,
                                    moe_ep_ref)
from repro_torch.serving.tp import run_grid  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "deepseek-v2-lite-16b"
# name: (config changes, x shape, phase, decode_tp, expected mode)
CASES = {
    "weights": (dict(), (2, 16, 64), "prefill", False, "weights"),
    "weights-drop": (dict(capacity_factor=0.5), (2, 16, 64), "prefill",
                     False, "weights"),
    "tokens": (dict(), (4, 1, 64), "decode", True, "tokens"),
    "tokens-drop": (dict(capacity_factor=0.5), (4, 1, 64), "decode", True,
                    "tokens"),
    "none": (dict(d_model=65), (2, 16, 65), "prefill", False, "none"),
}
GRIDS = {"1x4": ((1, 4), ["weights", "weights-drop", "tokens"]),
         "2x2": ((2, 2), ["weights", "weights-drop", "tokens",
                          "tokens-drop", "none"])}


def _cfg(changes):
    return dataclasses.replace(reduced_config(ARCH), **changes)


def _inputs(cfg, shape, seed):
    g = torch.Generator().manual_seed(seed)
    E, d, F = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": torch.randn(d, E, generator=g),
         "w_gate": torch.randn(E, d, F, generator=g) * 0.1,
         "w_up": torch.randn(E, d, F, generator=g) * 0.1,
         "w_down": torch.randn(E, F, d, generator=g) * 0.1}
    return torch.randn(*shape, generator=g), p


def _rank(groups, rank, mesh, cases):
    """One rank: moe_ep on its shards of every case; (its output block,
    its kept expert choices) per case."""
    out = []
    for cfg, x, p, phase, dtp in cases:
        ctx = make_ctx(cfg, mesh, phase, decode_tp=dtp,
                       ep_group=groups["model"], fsdp_group=groups["data"])
        xs, ps = ep_shards(x, p, cfg, ctx, rank)
        st = {}
        y = moe_ep(xs, ps, cfg, ctx, stats=st)
        out.append((y, int(st["kept"])))
    return out


_REF = textwrap.dedent("""
    import dataclasses, json, math, os, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs.archs import reduced_config
    from repro.models.moe import moe_ep, _route
    from repro.models.partition import AxisCtx, best_axes
    spec = json.loads(sys.argv[1])
    dd, mm = spec["grid"]
    mesh = jax.make_mesh((dd, mm), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for name, c in spec["cases"].items():
        cfg = dataclasses.replace(reduced_config(spec["arch"]),
                                  **c["changes"])
        z = np.load(c["path"])
        x, p = z["x"], {k: z[k] for k in ("router", "w_gate", "w_up",
                                          "w_down")}
        ctx = AxisCtx(mesh=mesh, phase=c["phase"], batch=("data",),
                      seq=("model",), ep=True, decode_tp=c["decode_tp"])
        y = jax.jit(lambda x, p: moe_ep(x, p, cfg, ctx))(x, p)
        # kept choices, rank by rank, with the reference's routing
        B, S, d = x.shape
        bax = best_axes(mesh, B, ctx.batch)
        sax = best_axes(mesh, S, ctx.seq)
        kept = 0
        for di in range(dd):
            for mi in range(mm):
                def loc(dj):
                    b = x[dj * B // dd:(dj + 1) * B // dd] if bax else x
                    return (b[:, mi * S // mm:(mi + 1) * S // mm] if sax
                            else b)
                tokens = (c["mode"] == "tokens")
                x2 = (np.concatenate([loc(j).reshape(-1, d)
                                      for j in range(dd)]) if tokens
                      else loc(di).reshape(-1, d))
                T = x2.shape[0]
                C = max(1, math.ceil(T * cfg.top_k / cfg.num_experts
                                     * cfg.capacity_factor))
                _, topi = _route(jnp.asarray(x2), jnp.asarray(p["router"]),
                                 cfg.top_k)
                seen = np.zeros(cfg.num_experts, int)
                for e in np.asarray(topi).reshape(-1):
                    kept += int(seen[e] < C)
                    seen[e] += 1
        np.save(c["out"], np.asarray(y))
        out[name] = kept
    print("KEPT" + json.dumps(out))
""")


def _reference(grid, cases, tmp_path):
    """The reference's moe_ep on a (data, model) CPU mesh of 4 devices with
    Auto axes: {name: (y, kept)}."""
    spec = {"arch": ARCH, "grid": list(grid), "cases": {}}
    for name, (cfg_changes, x, p, phase, dtp, mode) in cases.items():
        path = tmp_path / f"{name}.npz"
        np.savez(path, x=x.numpy(), **{k: v.numpy() for k, v in p.items()})
        spec["cases"][name] = dict(changes=cfg_changes, path=str(path),
                                   out=str(tmp_path / f"{name}_y.npy"),
                                   phase=phase, decode_tp=dtp, mode=mode)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _REF, json.dumps(spec)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    kept = json.loads(r.stdout.split("KEPT", 1)[1])
    return {name: (torch.from_numpy(np.load(spec["cases"][name]["out"])),
                   kept[name]) for name in cases}


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_moe_ep_ranks_equal_the_reference_and_the_plain_version(
        grid_name, tmp_path):
    grid, names = GRIDS[grid_name]
    mesh = make_local_mesh(model=grid[1], data=grid[0], device="cpu")
    cases, rank_cases = {}, []
    for i, name in enumerate(names):
        changes, shape, phase, dtp, mode = CASES[name]
        cfg = _cfg(changes)
        x, p = _inputs(cfg, shape, seed=10 + i)
        ctx = make_ctx(cfg, mesh, phase, decode_tp=dtp)
        assert gather_mode(cfg, ctx, grid[0]) == mode
        cases[name] = (changes, x, p, phase, dtp, mode)
        rank_cases.append((cfg, x, p, phase, dtp))
    results, codes = run_grid(_rank, mesh, (mesh, rank_cases))
    assert codes == [0, 0, 0]
    ref = _reference(grid, cases, tmp_path)
    for i, name in enumerate(names):
        changes, x, p, phase, dtp, mode = cases[name]
        cfg = _cfg(changes)
        ctx = make_ctx(cfg, mesh, phase, decode_tp=dtp)
        st = {}
        y_ref = moe_ep_ref(x, p, cfg, ctx, stats=st)
        y_jax, kept_jax = ref[name]
        assert torch.allclose(y_ref, y_jax, rtol=0, atol=1e-5), name
        kept = sum(res[i][1] for res in results)
        assert kept == kept_jax == int(st["kept"]), name
        for r in range(mesh.size):
            want = ep_shards(y_ref, p, cfg, ctx, r)[0]
            got = results[r][i][0]
            assert got.shape == want.shape
            assert torch.allclose(got, want, rtol=0, atol=1e-6), (name, r)
            assert torch.allclose(got, ep_shards(y_jax, p, cfg, ctx, r)[0],
                                  rtol=0, atol=1e-5), (name, r)
        if "drop" in name:
            every = dataclasses.replace(cfg, capacity_factor=float(
                cfg.num_experts))
            st_all = {}
            moe_ep_ref(x, p, every, ctx, stats=st_all)
            assert kept < int(st_all["kept"]), name      # tokens dropped


def test_capacity_drops_tokens():
    """At capacity factor 0.5 some expert choices find no slot; at a
    capacity that holds every choice, EP equals the dense MoE."""
    mesh = Mesh(("data", "model"), (2, 2))
    cfg = _cfg(dict(capacity_factor=0.5))
    x, p = _inputs(cfg, (2, 16, 64), seed=3)
    st = {}
    moe_ep_ref(x, p, cfg, make_ctx(cfg, mesh, "prefill"), stats=st)
    assert int(st["kept"]) < 2 * 16 * cfg.top_k
    big = _cfg(dict(capacity_factor=float(cfg.num_experts)))
    st = {}
    y = moe_ep_ref(x, p, big, make_ctx(big, mesh, "prefill"), stats=st)
    assert int(st["kept"]) == 2 * 16 * cfg.top_k
    assert torch.allclose(y, moe_dense(x, p, big), rtol=0, atol=1e-6)


def test_moe_apply_takes_ep_exactly_when_the_reference_would():
    """A mesh whose EP axis divides E: moe_ep_ref in one process (no
    group); no mesh, or an EP axis that does not divide E: the dense
    branch."""
    cfg = _cfg(dict(num_shared_experts=0, capacity_factor=0.5))
    x, p = _inputs(cfg, (2, 16, 64), seed=4)
    dense = moe_dense(x, p, cfg)
    ep = moe_ep_ref(x, p, cfg, make_ctx(cfg, Mesh(("data", "model"),
                                                  (1, 2)), "prefill"))
    assert not torch.allclose(ep, dense)          # tokens dropped
    got = moe_apply(x, p, cfg, make_ctx(cfg, Mesh(("data", "model"),
                                                  (1, 2)), "prefill"))
    assert torch.equal(got, ep)
    got = moe_apply(x, p, cfg, make_ctx(cfg, Mesh(("data", "model"),
                                                  (1, 3)), "prefill"))
    assert torch.equal(got, dense)                # 3 does not divide E=4
    assert torch.equal(moe_apply(x, p, cfg), dense)


def test_moe_ep_ref_on_meta_is_shapes_only():
    cfg = dataclasses.replace(reduced_config(ARCH), num_experts=16)
    mesh = Mesh(("data", "model"), (16, 16))
    x = torch.empty(32, 256, cfg.d_model, device="meta")
    p = {"router": torch.empty(64, 16, device="meta"),
         "w_gate": torch.empty(16, 64, 64, device="meta"),
         "w_up": torch.empty(16, 64, 64, device="meta"),
         "w_down": torch.empty(16, 64, 64, device="meta")}
    y = moe_ep_ref(x, p, cfg, make_ctx(cfg, mesh, "prefill"))
    assert y.shape == x.shape and y.device.type == "meta"
