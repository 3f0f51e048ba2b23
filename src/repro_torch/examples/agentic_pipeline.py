"""Collective (agentic/reasoning) pipelines under Tempo.

  PYTHONPATH=src python -m repro_torch.examples.agentic_pipeline

A collective-only workload (ToT math trees + agent chains with EVOLVING
DAGs — stage sizes hidden from the scheduler) on the simulated replica.
Shows (1) the dependency-graph matcher learning stage-time ratios online
and (2) the end-to-end effect of stage-budgeted deadlines vs plain FCFS.
"""

import numpy as np

from repro_torch.core.baselines import make_scheduler
from repro_torch.core.service import ServiceModel
from repro_torch.serving.engine import EngineConfig, ServeEngine, SimBackend
from repro_torch.serving.metrics import summarize
from repro_torch.serving.workload import WorkloadGen, WorkloadSpec


def main(duration: float = 120.0):
    spec = WorkloadSpec(rate=3.0, duration=duration, seed=5, mix=(0, 0, 1),
                        best_effort_frac=0.0)
    service = ServiceModel()

    for name in ("sarathi", "autellix", "tempo"):
        gen = WorkloadGen(spec)
        sched = make_scheduler(name)
        if getattr(sched, "needs_predictions", False):
            sched.predictor.warm_start(gen.warmup_requests(256))
        singles, dags = gen.generate()
        eng = ServeEngine(SimBackend.for_model("llama-8b"), sched,
                          EngineConfig(), workload=gen)
        eng.load(singles, dags)
        fin = eng.run()
        s = summarize(name, fin, service, eng.now)
        done = [d for d in eng.dags.values() if d.finished]
        e2e = sorted(d.finish_t - d.arrival for d in done)
        met = sum((d.finish_t - d.arrival) <= d.ttlt for d in done)
        print(f"{name:<10} dags={len(done)} "
              f"e2e_p50={e2e[len(e2e)//2]:.1f}s "
              f"e2e_p95={e2e[int(0.95*len(e2e))]:.1f}s "
              f"dag_deadline_met={met/len(done):.2f} "
              f"gain={s.service_gain:.0f}")
        if name == "tempo":
            m = sched.matcher
            napps = {k: len(v) for k, v in m.history.items()}
            us = float(np.median(m.match_us)) if m.match_us \
                else float("nan")
            print(f"           matcher history={napps}, pairwise match "
                  f"~{us:.1f}us (paper: 5us/pair super-node)")


if __name__ == "__main__":
    main()
