"""Quickstart: SLO-aware serving with Tempo vs FCFS in ~1 minute.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
      [--backend {sim,torch}] [--device cpu] [--tp N]

Generates a mixed-SLO workload (latency-streaming chat, deadline'd
throughput jobs, collective agent DAGs — paper §2.1) and serves it under
each scheduler, comparing Tempo's service gain / SLO goodput against
vLLM-style FCFS.

--backend sim (default): a simulated 8×TPU-v5e Llama-8B replica
(roofline step times) at paper scale.

--backend torch: the SAME engine and schedulers drive REAL PyTorch
execution — a reduced tinyllama decoding on a device-resident paged KV
cache (``PagedTorchBackend``; the hand-written CUDA paged attention on the
GPU) — over a length-capped workload that fits the device page pool.
Step times are measured wall time.  It runs on the GPU and raises without
CUDA; ``--device cpu`` runs the kernels' plain PyTorch versions instead.

--tp N (torch backend): serve tensor-parallel over N ranks, this process
and N-1 workers, with Megatron-sharded weights and a KV-head-sharded page
pool (DESIGN.md §8).  On the GPU it takes the first N cards and raises
with fewer; ``--device cpu`` runs N CPU ranks.  The printed
``stream-digest`` lines equal ``--tp 1``'s.

--disagg P:D: serve the same workload on a disaggregated fleet — P
prefill + D decode replicas with live KV migration and the role-aware
router.  On --backend torch the printed ``stream-digest`` lines equal the
colocated run's.
"""

import argparse
import hashlib
import os

from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.run import (BackendSpec, ClusterSpec,
                                     ExperimentSpec, TelemetrySpec,
                                     make_backend, run, run_cluster)
from repro_torch.serving.workload import WorkloadSpec


def _stream_digest(backends) -> str:
    """Order-independent digest of every request's generated tokens,
    merged across one or many replica backends (rids are fleet-unique:
    a migrated request's stream lives only on its final replica)."""
    if not isinstance(backends, (list, tuple)):
        backends = [backends]
    streams = sorted((rid, tuple(toks)) for bk in backends
                     for rid, toks in bk.generated.items())
    return hashlib.sha256(repr(streams).encode()).hexdigest()[:16]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("sim", "torch"), default="sim")
    ap.add_argument("--device", default=None,
                    help="torch backend's device (default: the GPU; 'cpu' "
                    "runs the kernels' plain PyTorch versions)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (torch backend): N ranks, "
                    "the first N cards on the GPU. Token streams equal "
                    "--tp 1")
    ap.add_argument("--scheduler", default=None,
                    help="serve ONLY this scheduler (e.g. gmg, tempo) "
                    "instead of the default comparison set")
    ap.add_argument("--scenario",
                    choices=("mixed", "multiturn", "agentic",
                             "deep_research"),
                    default="mixed",
                    help="mixed SLO traffic, the prefix-reuse workloads "
                    "(multi-turn chat / agentic chains), or long compound "
                    "research DAGs with evolving dependencies")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode micro-steps per device call on stable "
                    "decode-only steps (torch backend). Token streams "
                    "equal --decode-steps 1")
    ap.add_argument("--spec", type=int, default=0, metavar="N",
                    help="speculative decoding: draft up to N tokens per "
                    "lane (prompt-lookup drafter) and verify them in one "
                    "batched forward. Token streams equal --spec 0")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="shared-prefix KV reuse (default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--metrics-out", default=None,
                    help="enable telemetry: per-scheduler metric/trace "
                    "snapshots under DIR/<scheduler>/ plus a static "
                    "report.html in each")
    ap.add_argument("--disagg", default=None, metavar="P:D",
                    help="serve on a disaggregated fleet of P prefill + D "
                    "decode replicas with live KV migration instead of one "
                    "colocated replica.  Token streams equal the "
                    "colocated run's")
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error("--tp wants N >= 1")
    roles = None
    if args.disagg:
        try:
            p, d = (int(x) for x in args.disagg.split(":"))
        except ValueError:
            ap.error("--disagg wants P:D, e.g. --disagg 1:1")
        if p < 1 or d < 1:
            ap.error("--disagg needs at least one replica per role")
        roles = ["prefill"] * p + ["decode"] * d

    if args.backend == "torch":
        # real decoding: capped lengths so sequences fit the device pool
        if args.scenario == "mixed":
            spec = WorkloadSpec(rate=1.5, duration=6.0, seed=0,
                                mix=(2, 1, 1), prompt_cap=40, output_cap=12,
                                slo_scale=20.0)
        else:
            # per-segment caps keep accumulated histories in the pool;
            # deep_research additionally needs small stage counts so the
            # fan-in histories fit max_len
            research = dict(research_stages=(2, 3), research_breadth=2) \
                if args.scenario == "deep_research" else {}
            spec = WorkloadSpec(scenario=args.scenario, rate=0.5,
                                duration=8.0, seed=0, turns=(2, 3),
                                think_time=40.0, system_prompt_len=8,
                                shared_system_frac=1.0, prompt_cap=8,
                                output_cap=4, slo_scale=50.0, **research)
        engine_cfg = EngineConfig(max_batch=8, prefill_budget=32,
                                  prefix_cache=args.prefix_cache,
                                  decode_steps=args.decode_steps,
                                  spec_depth_max=args.spec, tp=args.tp)
        backend_kwargs = dict(arch="tinyllama-1.1b", num_blocks=64,
                              page=16, max_len=128, seed=0,
                              device=args.device, tp=args.tp)
        schedulers = ("vllm", "tempo")
    else:
        if args.scenario == "mixed":
            spec = WorkloadSpec(rate=8.0, duration=90.0, seed=0)
        else:
            rate = 1.0 if args.scenario == "deep_research" else 2.0
            spec = WorkloadSpec(scenario=args.scenario, rate=rate,
                                duration=90.0, seed=0,
                                system_prompt_len=256,
                                shared_system_frac=0.5)
        engine_cfg = EngineConfig(prefix_cache=args.prefix_cache,
                                  spec_depth_max=args.spec)
        backend_kwargs = None
        schedulers = ("vllm", "sarathi", "tempo")
    if args.scheduler:
        schedulers = (args.scheduler,)

    print(f"{'scheduler':<16} {'gain':>12} {'goodput':>9} {'tok/s':>9} "
          f"{'lat met':>8} {'thr met':>8} {'coll met':>9} {'cached':>7}")
    for name in schedulers:
        # build the backend explicitly (fresh per scheduler) so the real
        # token streams are digestable after the run
        backend = make_backend(args.backend, backend_kwargs) \
            if args.backend == "torch" and not roles else args.backend
        mdir = os.path.join(args.metrics_out, name) \
            if args.metrics_out else None
        if roles:
            sink = []
            f = run_cluster(ExperimentSpec(
                scheduler=name, workload=spec, engine=engine_cfg,
                backend=BackendSpec(kind=args.backend,
                                    kwargs=backend_kwargs, sink=sink),
                cluster=ClusterSpec(router="disagg", roles=roles),
                telemetry=TelemetrySpec(metrics_out=mdir)))
            s, backend = f.fleet, sink
        else:
            s = run(ExperimentSpec(
                scheduler=name, workload=spec, engine=engine_cfg,
                backend=BackendSpec(kind=backend, kwargs=backend_kwargs),
                telemetry=TelemetrySpec(metrics_out=mdir)))
        if mdir:
            from repro_torch.launch.dashboard import write_report
            write_report(mdir, title=f"Fleet telemetry — {name} "
                         f"@{args.backend}")
        pt = s.per_type
        get = lambda k: pt.get(k, {}).get("slo_met", float("nan"))
        print(f"{name:<16} {s.service_gain:>12.0f} {s.goodput_frac:>9.3f} "
              f"{s.throughput_tok_s:>9.0f} {get('latency'):>8.2f} "
              f"{get('throughput'):>8.2f} {get('collective'):>9.2f} "
              f"{s.cached_frac:>7.2f}")
        if s.n_finished <= 0 or s.goodput_frac <= 0.0:
            raise SystemExit(f"{name}@{args.backend}: no goodput")
        if roles:
            print(f"  [disagg {args.disagg}] migrated "
                  f"{s.migrated_in} requests (prefill -> decode)")
        if args.scenario != "mixed" and args.prefix_cache and not roles \
                and s.prefix_hits <= 0:
            raise SystemExit(f"{name}@{args.backend}: prefix cache never "
                             "hit")
        if args.backend == "torch":
            # equal across --disagg, --decode-steps, --spec and --tp by
            # construction; the lines make that checkable from the console
            print(f"stream-digest {name} {_stream_digest(backend)}")
            for bk in backend if isinstance(backend, list) else [backend]:
                bk.close()      # tp > 1: checks the ranks, stops workers

    if args.backend == "torch":
        where = backend[0].device if isinstance(backend, list) \
            else backend.device
        extra = (f", tensor-parallel over {args.tp} ranks"
                 if args.tp > 1 else "")
        print("\nReal PyTorch execution behind the Backend protocol: the "
              "same run loop, schedulers, KV accounting, eviction — and "
              "prefix-cache COW sharing — drive an actual model decoding "
              f"on a paged KV cache ({where}{extra}).")
    else:
        print("\nTempo allocates just-enough bandwidth per SLO (paced "
              "streaming, deadline-pressure density, stage-budgeted DAGs) "
              "-> higher goodput at ~equal raw throughput.")


if __name__ == "__main__":
    main()
