"""End-to-end training entry point (the reference's
``repro.launch.train``).

Features: gradient accumulation (microbatching), int8 gradient compression
with error feedback, checkpoint/restart (+ injected-failure drill),
straggler monitoring.  Runs on the GPU unless ``--device cpu`` is given;
``--reduced`` takes the tiny same-family config.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 60 --batch 8 --seq 128 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm3-4b \\
      --reduced --steps 30 --accum 2 --compress --fail-at 17 --device cpu
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs.archs import reduced_config
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, PackedLoader, device_batches
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.convert import tree_map
from repro_torch.models.model import build_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import (compress_grads,
                                              init_error_feedback)
from repro_torch.training.fault_tolerance import TrainSupervisor
from repro_torch.training.optimizer import get_optimizer

# checkpoints go under the checkout's build directory unless told otherwise
CKPT_ROOT = Path(__file__).resolve().parents[3] / "build" / "checkpoints"


def make_accum_train_step(model, opt, accum: int = 1, compress: bool = False):
    """step(params, (opt_state, ef), batch) -> (params, (opt_state, ef),
    loss): the gradient of ``model.loss`` over ``accum`` microbatches (the
    batch's rows split in order), summed in f32 accumulators and divided by
    ``accum``, then optionally int8-compressed with error feedback ``ef``,
    then one optimizer update.  ``ef`` is passed through untouched without
    ``compress``."""

    def step(params, state, batch):
        opt_state, ef = state
        if accum == 1:
            loss, grads = value_and_grad(model.loss, params, batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            lsum = 0.0
            for i in range(accum):
                loss, g = value_and_grad(model.loss, params,
                                         {k: v[i] for k, v in micro.items()})
                acc = tree_map(torch.add, acc, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / accum, acc)
            loss = lsum / accum
        if compress:
            grads, ef = compress_grads(grads, ef)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, (opt_state, ef), loss

    return step


def check_device(device: str) -> torch.device:
    """The run's device; a CUDA device must exist (no fallback to the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: CUDA is not available "
                           "(pass --device cpu to train on the CPU)")
    return dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(CKPT_ROOT / "train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (FT drill)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    dev = check_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    opt = get_optimizer(cfg, lr=args.lr)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    ef = init_error_feedback(params)

    step_fn = make_accum_train_step(model, opt, args.accum, args.compress)

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    loader = PackedLoader(dcfg)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    sup = TrainSupervisor(step_fn, ckpt, ckpt_every=args.ckpt_every)

    def make_batches(start_step):
        return device_batches(loader, dev)

    t0 = time.time()
    out = sup.run_with_recovery(params, (opt_state, ef), make_batches,
                                args.steps, fail_at_step=args.fail_at)
    dt = time.time() - t0
    ls = out["losses"]
    print(f"arch={cfg.name} device={dev} steps={out['final_step']} "
          f"restarts={out['restarts']} "
          f"loss[first5]={[round(x, 3) for x in ls[:5]]} "
          f"loss[last5]={[round(x, 3) for x in ls[-5:]]} wall={dt:.1f}s "
          f"stragglers={out['stragglers'][:5]}")
    if not ls[-1] < ls[0]:
        raise SystemExit("loss did not decrease")
    print("TRAIN OK")


if __name__ == "__main__":
    main()
