"""End-to-end LM training on the port's substrate (the reference's
``examples/train_lm.py``): synthetic packed data pipeline, AdamW,
checkpointing + injected-failure recovery, int8 gradient compression.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --hundred-m \\
      --steps 300

Runs on the GPU unless ``--device cpu`` is given.  (The paper is a serving
system, so serve_mixed_slo.py is the primary end-to-end example; this
exercises the training path of the same substrate.)
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, PackedLoader, device_batches
from repro_torch.launch.train import (CKPT_ROOT, check_device,
                                      make_accum_train_step)
from repro_torch.models.model import build_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import init_error_feedback
from repro_torch.training.fault_tolerance import TrainSupervisor
from repro_torch.training.optimizer import get_optimizer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--fail-at", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=str(CKPT_ROOT / "train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    dev = check_device(args.device)
    if args.hundred_m:
        cfg = ModelConfig(name="lm-100m", family="dense", num_layers=12,
                          d_model=768, num_heads=12, num_kv_heads=4,
                          d_ff=2048, vocab_size=32000, dtype="float32",
                          remat=False)
    else:
        cfg = ModelConfig(name="lm-30m", family="dense", num_layers=8,
                          d_model=512, num_heads=8, num_kv_heads=4,
                          d_ff=1408, vocab_size=8192, dtype="float32",
                          remat=False)
    model = build_model(cfg)
    print(f"model={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={dev}")

    opt = get_optimizer(cfg, lr=3e-3)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    step_fn = make_accum_train_step(model, opt, accum=1, compress=True)
    loader = PackedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                     global_batch=8))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    sup = TrainSupervisor(step_fn, ckpt, ckpt_every=20)

    def make_batches(start):
        return device_batches(loader, dev)

    t0 = time.time()
    out = sup.run_with_recovery(
        params, (opt.init(params), init_error_feedback(params)),
        make_batches, args.steps, fail_at_step=args.fail_at)
    ls = out["losses"]
    print(f"steps={out['final_step']} restarts={out['restarts']} "
          f"loss {ls[0]:.3f} -> {ls[-1]:.3f} wall={time.time()-t0:.0f}s")
    if not ls[-1] < ls[0]:
        raise SystemExit("loss did not decrease")
    print("TRAIN EXAMPLE OK")


if __name__ == "__main__":
    main()
