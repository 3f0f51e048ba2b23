"""End-to-end serving entry point.

  PYTHONPATH=src python -m repro_torch.launch.serve [--scheduler S]
      [--rate R] [--duration T] [--seed N] [--bursty]
      [--fail-at T | --real [--device cpu]]

Default: simulated v5e replica (roofline-derived step times) under a chosen
scheduler and workload; prints the Summary row and per-type SLO metrics.

--fail-at T runs the fault-tolerance drill: the engine "crashes" at time T,
a fresh engine is rebuilt from the request journal (arrivals + completion
state — the paper §5's "metadata backups enable fast recovery"), unfinished
requests are resubmitted (prefill recomputed), and serving continues; the
report includes recovery overhead.

--real serves a length-capped workload on ``PagedTorchBackend`` instead —
the same engine/scheduler stack over real decoding of a reduced tinyllama,
on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.baselines import make_scheduler
from repro_torch.core.service import ServiceModel
from repro_torch.serving.engine import EngineConfig, ServeEngine, SimBackend
from repro_torch.serving.metrics import summarize
from repro_torch.serving.request import ReqState
from repro_torch.serving.workload import WorkloadGen, WorkloadSpec


def run_with_failover(scheduler_name: str, spec: WorkloadSpec,
                      fail_at: float, service: ServiceModel):
    gen = WorkloadGen(spec)
    sched = make_scheduler(scheduler_name)
    if getattr(sched, "needs_predictions", False):
        sched.predictor.warm_start(gen.warmup_requests(256))
    singles, dags = gen.generate()
    eng = ServeEngine(SimBackend.for_model("llama-8b"), sched,
                      EngineConfig(), workload=gen)
    eng.load(singles, dags)
    eng.run(until=fail_at, drain=False)

    # ---- crash: rebuild from the journal -----------------------------
    journal = [r for r in eng.requests.values()]
    finished_before = list(eng.finished)
    crash_t = eng.now
    sched2 = make_scheduler(scheduler_name)
    if getattr(sched2, "needs_predictions", False):
        sched2.predictor.warm_start(gen.warmup_requests(256))
    eng2 = ServeEngine(SimBackend.for_model("llama-8b"), sched2,
                       EngineConfig(), workload=gen)
    eng2.now = crash_t + 2.0            # restart penalty (reload weights)
    eng2.dags = eng.dags
    resubmitted = 0
    for r in journal:
        if r.state == ReqState.FINISHED:
            continue
        # journal keeps arrival + prompt; in-flight progress is lost
        r.prefilled = 0
        r.decoded = 0
        r.token_times = []
        r.first_token_t = None
        r.state = ReqState.WAITING
        eng2.requests[r.rid] = r
        sched2.on_arrival(r, eng2._view())
        resubmitted += 1
    eng2._pending = eng._pending
    eng2.finished = finished_before
    finished = eng2.run()
    s = summarize(f"{scheduler_name}+failover", finished, service, eng2.now,
                  preemptions=eng.preempt_count + eng2.preempt_count)
    return s, dict(crash_t=round(crash_t, 1), resubmitted=resubmitted)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="tempo")
    ap.add_argument("--rate", type=float, default=6.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bursty", action="store_true")
    ap.add_argument("--fail-at", type=float, default=None)
    ap.add_argument("--real", action="store_true",
                    help="real tiny-model decoding instead of the simulator")
    ap.add_argument("--device", default=None,
                    help="--real's device (default: the GPU)")
    args = ap.parse_args(argv)

    service = ServiceModel()
    spec = WorkloadSpec(rate=args.rate, duration=args.duration,
                        seed=args.seed, bursty=args.bursty)

    if args.real:
        # same engine/scheduler stack, real paged-KV execution
        from repro_torch.serving.run import BackendSpec, ExperimentSpec, run
        spec = WorkloadSpec(rate=1.0, duration=5.0, seed=args.seed,
                            prompt_cap=48, output_cap=24, slo_scale=20.0)
        s = run(ExperimentSpec(
            scheduler=args.scheduler, workload=spec, service=service,
            engine=EngineConfig(max_batch=8, prefill_budget=48),
            backend=BackendSpec(kind="torch",
                                kwargs=dict(num_blocks=64, page=16,
                                            max_len=96, seed=args.seed,
                                            device=args.device))))
        print(json.dumps(s.row()))
        return

    if args.fail_at is not None:
        s, info = run_with_failover(args.scheduler, spec, args.fail_at,
                                    service)
        print(json.dumps({**s.row(), **info}))
        return

    from repro_torch.serving.run import ExperimentSpec, run
    s = run(ExperimentSpec(scheduler=args.scheduler, workload=spec,
                           service=service))
    print(json.dumps(s.row()))
    for k, v in s.per_type.items():
        print(k, json.dumps({kk: round(vv, 4) for kk, vv in v.items()}))


if __name__ == "__main__":
    main()
