"""Dry run of every (architecture x input shape) cell against the
production mesh (the reference's ``repro.launch.dryrun``), as a ``meta``
pass: no tensor is allocated and nothing is computed, shapes alone.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
      [--multi-pod] [--decode-tp] [--attn triangle] [--out out.json]
  python -m repro_torch.launch.dryrun --all [--multi-pod]   # subprocesses
  python -m repro_torch.launch.report --dir experiments/dryrun_torch

A cell builds its step (``launch.steps``) with the mesh's context
(``launch.sharding.make_ctx``), takes ``meta`` parameters
(``Model.param_specs``, the counterpart of ``jax.eval_shape(model.init)``),
optimizer state and inputs (``Model.input_specs``), and runs the step
once under ``launch.roofline.CostCounter``.  MoE layers go through
``models.moe.moe_ep_ref`` over the mesh's shards, so the count is the
capacity-bounded expert FFN (E x C rows per shard), not the dense
branch's E x T; attention on ``meta`` takes the kernels' plain versions
(nothing runs) and is counted by the kernels' analytic costs.

The record's keys are the reference's, so ``launch.report`` renders it:

- ``argument_size_in_bytes``, ``output_size_in_bytes`` and
  ``alias_size_in_bytes`` are exact: each leaf's bytes divided by the
  product of the axis sizes its spec names (``launch.sharding``), over the
  parameters, optimizer state, batch and caches, with the reference's
  donation (train: parameters and optimizer state; decode: the caches).
  The logits leave sharded over the batch axes and the vocabulary over
  'model', as XLA chose for the reference; the loss is replicated.
- ``temp_size_in_bytes`` is an ESTIMATE: the pass's peak of live
  ``meta``-tensor bytes (tensors the step allocated; the kernels' plain
  internals excepted), divided by the activations' sharding (the batch
  axes x the sequence axes that divide them; in decode, the cache's
  sequence, which its temporaries follow).
- ``hlo_flops_per_chip``: the counted global FLOPs / chips (likewise the
  byte counts).
- ``coll_bytes_per_chip`` / ``coll_by_kind`` / ``coll_count`` come from an
  analytic plan, with the reference's ring factors
  (``roofline.wire_bytes``): an all-gather of every sharded parameter leaf
  at each use (per unit for stacked leaves; twice in training, forward and
  backward; expert weights over the FSDP axis only, none when decode TP
  keeps them resident, and none for the Megatron-resident leaves of
  ``tp`` mode); in training, a reduce-scatter of each such gradient; under
  decode TP, an all-reduce of the (B, 1, d) activations after every
  sharded wo and w_down; and the EP all-to-alls (and, in 'tokens' mode,
  the token all-gathers and expert psums) that ``moe_ep_ref`` tells the
  counter, per rank.  Not in the plan: the resharding XLA inserts around
  sequence-sharded attention and recurrences.  ``coll_group`` is the
  largest group, whose link rate ``roofline_terms`` takes.

Records go to ``experiments/dryrun_torch/`` by default, never the
reference's folder.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def per_device_bytes(mesh, tree, specs) -> int:
    """Bytes one device holds of ``tree`` under the spec tree ``specs``."""
    from repro_torch.launch.sharding import shard_factor

    spec_of = dict(_leaves_specs(specs))
    return sum(_nbytes(t) // shard_factor(mesh, spec_of[path])
               for path, t in _leaves(tree))


def _leaves_specs(specs, path=()):
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _leaves_specs(v, path + (k,))
    elif isinstance(specs, list) or (isinstance(specs, tuple) and specs
                                     and isinstance(specs[0], dict)):
        for i, v in enumerate(specs):
            yield from _leaves_specs(v, path + (i,))
    else:
        yield path, specs


def collective_plan(cfg, mesh, ctx, params, specs, kind: str,
                    mode: str, B_local: int, counter) -> None:
    """Add the analytic plan's collectives (module docstring) to
    ``counter``: FSDP gathers and gradient reduce-scatters of the
    parameter leaves, decode-TP psums."""
    from repro_torch.launch.sharding import _ATTN_TP
    from repro_torch.models.moe import gather_mode
    from repro_torch.models.partition import entry_axes

    sizes = mesh.shape
    spec_of = dict(_leaves_specs(specs))
    fsdp = sizes[ctx.fsdp_axis]
    expert_mode = gather_mode(cfg, ctx, fsdp) if cfg.num_experts else None
    uses = 2 if kind == "train" else 1
    for path, leaf in _leaves(params):
        spec = spec_of[path]
        name = path[-1]
        stacked = "units" in path
        units = leaf.shape[0] if stacked else 1
        axes = [a for e in spec for a in entry_axes(e)]
        is_expert = (cfg.num_experts > 0 and name in
                     ("w_gate", "w_up", "w_down")
                     and leaf.dim() - stacked == 3
                     and leaf.shape[-3] == cfg.num_experts)
        if is_expert:
            axes = [] if expert_mode == "tokens" else \
                [a for a in axes if a != ctx.ep_axis]
        elif mode == "tp" and name in _ATTN_TP and "model" in axes:
            axes = []               # Megatron: resident, psum'd instead
        if not axes:
            continue
        g = math.prod(sizes[a] for a in axes)
        held = math.prod(sizes[a] for e in spec for a in entry_axes(e))
        result = _nbytes(leaf) / units / (held // g)
        counter.collective("all-gather", result, g, uses * units)
        if kind == "train":
            counter.collective("reduce-scatter", result / g, g, units)
    if kind == "decode" and ctx.decode_tp:
        act = B_local * cfg.d_model * torch.empty(
            (), dtype=getattr(torch, cfg.dtype)).element_size()
        m = sizes["model"]
        for path, leaf in _leaves(params):
            name = path[-1]
            if name not in ("wo", "w_down") or "model" not in [
                    a for e in spec_of[path] for a in entry_axes(e)]:
                continue
            units = leaf.shape[0] if "units" in path else 1
            counter.collective("all-reduce", act, m, units)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             decode_tp: bool = False, attn_schedule: str = "rect",
             extra: dict | None = None) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import applicable, get_shape
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import CostCounter, model_flops
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models.partition import best_axes

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec: dict = dict(arch=arch, shape=shape_name, multi_pod=multi_pod,
                     decode_tp=decode_tp, attn_schedule=attn_schedule)
    if extra:
        rec.update(extra)
    if not applicable(cfg, shape):
        rec["status"] = "skip(full-attn)"
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.time()
    ctx = sh.make_ctx(cfg, mesh, shape.kind, decode_tp=decode_tp,
                      attn_schedule=attn_schedule)
    mode = "tp" if decode_tp else "fsdp"
    counter = CostCounter(track_live=True)
    B, S = shape.global_batch, shape.seq_len

    def logits_spec(logits):
        return (best_axes(mesh, logits.shape[0], ctx.batch),
                best_axes(mesh, logits.shape[1], ("model",)))

    if shape.kind == "train":
        model, opt, step = make_train_step(cfg, ctx)
        params = model.param_specs()
        opt_s = opt.init(params)
        batch = model.input_specs(shape)["batch"]
        p_sh = sh.params_shardings(cfg, mesh, params)
        o_sh = sh.opt_shardings(cfg, mesh, opt_s)
        b_sh = sh.batch_shardings(ctx, batch)
        with counter:
            new_p, new_o, loss = step(params, opt_s, batch)
        args = [(params, p_sh), (opt_s, o_sh), (batch, b_sh)]
        outs = [(new_p, p_sh), (new_o, o_sh), (loss, ())]
        donated = args[:2]
        act = (B, S)
    elif shape.kind == "prefill":
        model, step = make_prefill_step(cfg, ctx)
        params = model.param_specs()
        batch = model.input_specs(shape)["batch"]
        p_sh = sh.params_shardings(cfg, mesh, params, mode=mode)
        b_sh = sh.batch_shardings(ctx, batch)
        with counter:
            logits, caches = step(params, batch)
        c_sh = sh.cache_shardings(ctx, caches)
        args = [(params, p_sh), (batch, b_sh)]
        outs = [(logits, logits_spec(logits)), (caches, c_sh)]
        donated = []
        act = (B, S)
    else:
        model, step = make_serve_step(cfg, ctx)
        params = model.param_specs()
        specs = model.input_specs(shape)
        p_sh = sh.params_shardings(cfg, mesh, params, mode=mode)
        c_sh = sh.cache_shardings(ctx, specs["caches"])
        t_sh = sh.batch_shardings(ctx, {"tokens": specs["tokens"]})["tokens"]
        with counter:
            logits, caches = step(params, specs["caches"], specs["tokens"],
                                  specs["index"])
        args = [(params, p_sh), (specs["caches"], c_sh),
                (specs["tokens"], t_sh), (specs["index"], ())]
        outs = [(logits, logits_spec(logits)), (caches, c_sh)]
        donated = [args[1]]
        act = (B, S)                # the temporaries follow the caches
    B_local = B // sh.shard_factor(mesh, (best_axes(mesh, B, ctx.batch),))
    collective_plan(cfg, mesh, ctx, params, p_sh, shape.kind, mode, B_local,
                    counter)
    count_s = time.time() - t0

    def size(pairs):
        return sum(per_device_bytes(mesh, tree, spec) for tree, spec in pairs)

    act_factor = sh.shard_factor(mesh, (best_axes(mesh, act[0], ctx.batch),
                                        best_axes(mesh, act[1], ctx.seq)))
    rec.update(status="ok", chips=chips, meta_s=round(count_s, 1))
    rec["argument_size_in_bytes"] = size(args)
    rec["output_size_in_bytes"] = size(outs)
    rec["alias_size_in_bytes"] = size(donated)
    rec["temp_size_in_bytes"] = counter.peak_live // act_factor
    rec["temp_is_estimate"] = True
    rec["per_device_bytes"] = (rec["argument_size_in_bytes"]
                               + rec["temp_size_in_bytes"]
                               + max(0, rec["output_size_in_bytes"]
                                     - rec["alias_size_in_bytes"]))
    counted = counter.record(chips=chips)
    counted.pop("kernel_reports", None)
    rec.update(counted)
    rec["coll_group"] = counter.max_group
    rec["model_flops"] = model_flops(cfg, shape)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--decode-tp", action="store_true")
    ap.add_argument("--attn", default="rect", choices=["rect", "triangle"])
    ap.add_argument("--out", default="")
    ap.add_argument("--all", action="store_true",
                    help="run every cell, each in a subprocess")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    args = ap.parse_args()

    if args.all:
        from repro_torch.configs.shapes import all_cells
        os.makedirs(args.outdir, exist_ok=True)
        failures = []
        for arch, shape_name, runnable in all_cells():
            tag = f"{arch}__{shape_name}" + ("__mp" if args.multi_pod else "")
            out = os.path.join(args.outdir, tag + ".json")
            if os.path.exists(out):
                print(f"[skip existing] {tag}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", out]
            if args.multi_pod:
                cmd.append("--multi-pod")
            print(f"[run] {tag}", flush=True)
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                failures.append(tag)
                with open(out + ".err", "w") as f:
                    f.write(r.stdout + "\n" + r.stderr)
                print(f"[FAIL] {tag}: {r.stderr.strip().splitlines()[-1:]}",
                      flush=True)
        print(f"done; failures: {failures}")
        sys.exit(1 if failures else 0)

    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   decode_tp=args.decode_tp, attn_schedule=args.attn)
    js = json.dumps(rec, indent=2, default=str)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
