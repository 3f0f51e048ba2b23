"""Cluster serving: one workload, N co-simulated replicas, SLO-aware routing.

  PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--autoscale]
      [--scheduler tempo|gmg|...]

Default: routes a mixed-SLO workload (paper §2.1: latency streams, deadline
jobs, collective agent DAGs) across a 4-replica fleet under every router
policy and compares fleet goodput.  --autoscale: starts from one replica
under a 5x triangular load ramp and lets the goodput-driven autoscaler grow
and drain the fleet.
"""

import argparse

from repro_torch.cluster.autoscaler import AutoscalerConfig
from repro_torch.cluster.router import ROUTERS
from repro_torch.serving.run import ClusterSpec, ExperimentSpec, run_cluster
from repro_torch.serving.workload import WorkloadSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--scheduler", default="tempo",
                    help="per-replica scheduler (tempo, gmg, ...)")
    args = ap.parse_args(argv)

    if args.autoscale:
        spec = WorkloadSpec(rate=6.0, duration=60.0, seed=3, ramp_peak=5.0)
        f = run_cluster(ExperimentSpec(
            scheduler=args.scheduler, workload=spec, warmup=192,
            cluster=ClusterSpec(
                router="slo-margin", n_replicas=1, autoscale=True,
                autoscaler_cfg=AutoscalerConfig(
                    min_replicas=1, max_replicas=6,
                    cooldown=6.0, window=20.0))))
        print(f"fleet goodput={f.goodput_frac:.3f} "
              f"finished={f.fleet.n_finished}")
        print("replica-count timeline (t, n_active):")
        for t, n in f.replica_timeline:
            print(f"  {t:7.1f}s  {'█' * n} {n}")
        return

    spec = WorkloadSpec(rate=44.0, duration=18.0, seed=4)
    print(f"{'router':<14} {'goodput':>8} {'gain':>10} {'lat met':>8} "
          f"{'coll met':>9} {'routed/replica'}")
    for router in ROUTERS:
        f = run_cluster(ExperimentSpec(
            scheduler=args.scheduler, workload=spec, warmup=192,
            cluster=ClusterSpec(router=router, n_replicas=4)))
        pt = f.fleet.per_type
        get = lambda k: pt.get(k, {}).get("slo_met", float("nan"))
        routed = [n for _, n in sorted(f.routed.items())]
        print(f"{router:<14} {f.goodput_frac:>8.4f} "
              f"{f.fleet.service_gain:>10.0f} {get('latency'):>8.3f} "
              f"{get('collective'):>9.3f} {routed}")
    print("\nslo-margin routes each SLO class by its binding resource "
          "(decode slots, backlog margin, long-run DAG work share) -> "
          "highest fleet goodput near saturation.")


if __name__ == "__main__":
    main()
