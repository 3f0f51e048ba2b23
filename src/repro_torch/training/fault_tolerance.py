"""Fault tolerance for training: supervised step loop with checkpoint /
restart, failure injection, and straggler monitoring.

`TrainSupervisor.run` drives `n_steps` of a jitted train_step, checkpointing
every `ckpt_every`.  `fail_at_step` injects a simulated node failure
(exception) — `run_with_recovery` then restarts from the latest checkpoint
and continues, verifying step continuity.  The same path handles elastic
restarts: pass a different mesh/shardings on resume and the checkpoint
reshards (see CheckpointManager.restore).

`StragglerMonitor` tracks per-step wall times; steps slower than
`threshold ×` the running median are flagged (on a real cluster this feeds
the scheduler's slow-host eviction; here it is surfaced in metrics and
exercised by tests)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.training.checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float):
        self.times.append(dt)
        if len(self.times) >= 8:
            med = sorted(self.times[-64:])[len(self.times[-64:]) // 2]
            if dt > self.threshold * med:
                self.flagged.append(step)


class TrainSupervisor:
    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 ckpt_every: int = 10):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()

    def run(self, params, opt_state, batches, n_steps: int,
            start_step: int = 0, fail_at_step: Optional[int] = None):
        losses = []
        step = start_step
        for batch in batches:
            if step >= n_steps:
                break
            if fail_at_step is not None and step == fail_at_step:
                raise SimulatedFailure(f"node failure at step {step}")
            t0 = time.perf_counter()
            params, opt_state, loss = self.step_fn(params, opt_state, batch)
            self.monitor.observe(step, time.perf_counter() - t0)
            losses.append(float(loss))
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, params, opt_state)
        return params, opt_state, step, losses

    # ------------------------------------------------------------------
    def run_with_recovery(self, init_params, init_opt, make_batches,
                          n_steps: int, fail_at_step: Optional[int] = None,
                          param_shardings=None, opt_shardings=None
                          ) -> Dict[str, Any]:
        """Run to completion, restarting once from the latest checkpoint if
        a (possibly injected) failure occurs."""
        params, opt = init_params, init_opt
        restarts = 0
        losses: List[float] = []
        start = 0
        while True:
            try:
                params, opt, start, ls = self.run(
                    params, opt, make_batches(start), n_steps,
                    start_step=start,
                    fail_at_step=fail_at_step if restarts == 0 else None)
                losses.extend(ls)
                break
            except SimulatedFailure:
                restarts += 1
                latest = self.ckpt.latest_step()
                assert latest is not None, "failure before first checkpoint"
                params, opt, meta = self.ckpt.restore(
                    latest, params, opt,
                    param_shardings=param_shardings,
                    opt_shardings=opt_shardings)
                start = meta["step"]
        return dict(params=params, opt=opt, losses=losses,
                    restarts=restarts, final_step=start,
                    stragglers=list(self.monitor.flagged))
