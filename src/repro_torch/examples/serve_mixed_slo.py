"""End-to-end serving example (the paper's deployment scenario).

  PYTHONPATH=src python -m repro_torch.examples.serve_mixed_slo \\
      [--real [--device cpu]]

Default: full scheduler comparison across a bursty mixed-SLO workload with
per-type latency breakdown (paper fig. 14 style) on the simulated replica.
--real: the same ServeEngine + Tempo scheduler drive REAL PyTorch decoding
of a reduced tinyllama against a device-resident paged KV cache
(``PagedTorchBackend``), on the GPU unless ``--device cpu`` is given.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", default=None,
                    help="--real's device (default: the GPU)")
    args = ap.parse_args(argv)

    if args.real:
        from repro_torch.core.baselines import make_scheduler
        from repro_torch.serving.engine import EngineConfig, ServeEngine
        from repro_torch.serving.torch_backend import PagedTorchBackend
        from repro_torch.serving.workload import WorkloadGen, WorkloadSpec
        gen = WorkloadGen(WorkloadSpec(rate=2.0, duration=4.0, seed=0,
                                       prompt_cap=24, output_cap=20,
                                       slo_scale=20.0))
        singles, _ = gen.generate()
        reqs = singles[:6]
        backend = PagedTorchBackend("tinyllama-1.1b", num_blocks=24,
                                    page=16, max_len=48, seed=0,
                                    device=args.device)
        eng = ServeEngine(backend, make_scheduler("tempo",
                                                  use_predictor=False),
                          EngineConfig(max_batch=4, prefill_budget=32))
        eng.load(reqs, [])
        eng.run()
        for r in reqs:
            print(f"rid={r.rid} kind={r.slo.kind:<10} done={r.done} "
                  f"tokens={backend.generated[r.rid][:8]}...")
        print(f"real PyTorch decoding under Tempo ({backend.device}): OK")
        return

    from repro_torch.serving.run import ExperimentSpec, run
    from repro_torch.serving.workload import WorkloadSpec
    spec = WorkloadSpec(rate=8.0, duration=120.0, seed=3, bursty=True)
    for name in ("vllm", "sarathi", "autellix", "sjf", "tempo",
                 "tempo-precise"):
        s = run(ExperimentSpec(scheduler=name, workload=spec))
        print(f"\n== {name}: gain={s.service_gain:.0f} "
              f"goodput={s.goodput_frac:.3f} tok/s={s.throughput_tok_s:.0f}")
        for kind, v in s.per_type.items():
            # percentiles are None (not NaN) for classes with no samples
            fmt = lambda x, scale=1.0, nd=2: \
                "-" if x is None else f"{x * scale:.{nd}f}"
            print(f"   {kind:<11} met={v['slo_met']:.2f} "
                  f"ttft_p95={fmt(v['ttft_p95'])}s "
                  f"tbt_p95={fmt(v['tbt_p95'], 1e3, 0)}ms "
                  f"ttlt_p95={fmt(v['ttlt_p95'], 1.0, 1)}s")


if __name__ == "__main__":
    main()
