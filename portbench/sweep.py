"""Find a cell's knee: the highest Poisson rate the server sustains, that
is, with no growing backlog (the live requests at the window's end within
a quarter of those at its start).  Attainment is printed beside it.

    python3 portbench/sweep.py --workload <cell> --rates 1,2,3 \\
        --seconds 50 --seed <n> [--drain 30] [--out FILE]

One process builds the cell's serving stack once; each rate then gets a
fresh scheduler and engine, the traffic's pre-roll and a window of
``--seconds``, and is served on for up to ``--drain`` seconds after the
window so that the window's requests can finish.  A request still
unfinished then counts as a miss.  Per rate one JSON line: attainment,
the live requests at the window's start and end (the backlog), the
tokens per second, and the mean duration of the window's requests (due
to last token), which sets the traffic's pre-roll.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path[:] = [str(Path(__file__).resolve().parents[1])] + [
    p for p in sys.path
    if Path(p or ".").resolve() != Path(__file__).resolve().parent]

from portbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    import argparse
    import json

    import numpy as np
    import torch

    from portbench import serve, slo, traffic
    from portbench.bench import Bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--drain", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench = Bench(bench_run.ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    base = bench.traffic(cell["traffic"])
    if args.device != "cpu":
        from repro_torch.kernels import build
        build.build(["paged_attention"])
    served = serve.Served(cfg, base, args.seed, args.device)
    served.warm()
    for rate in (float(r) for r in args.rates.split(",")):
        t = dict(base, rate=rate)
        served.t = t
        served.fresh()
        specs, start, end = traffic.generate(t, args.seed, args.seconds,
                                             cfg["vocab_size"])
        specs = [s for s in specs if s.due < end]
        t0 = time.perf_counter()
        live = {}
        recs = served.serve(specs, end + args.drain, tracer=_Probe(
            served.engine, start, end, live), idle_after=end)
        close = end + args.drain
        win = slo.window(recs, start, end)
        met, judged, cens = slo.attainment(recs, start, end, close)
        done = [r.stamps[-1] - r.due for r in win if r.finished]
        row = dict(cell=args.workload, rate=rate, seed=args.seed,
                   window=len(win), met=met, attainment=met / max(len(win), 1),
                   unfinished=cens, live_at_start=live.get("start"),
                   live_at_end=live.get("end"),
                   output_tok_s=slo.output_tok_s(recs, start, end),
                   goodput_tok_s=slo.goodput_tok_s(recs, start, end),
                   ttft_p90_ms=(slo.pctl(slo.ttfts(recs, start, end), 90)
                                or 0) * 1e3,
                   tbt_p95_ms=(slo.pctl(slo.tbts(recs, start, end), 95)
                               or 0) * 1e3,
                   mean_duration_s=float(np.mean(done)) if done else None,
                   wall_s=time.perf_counter() - t0,
                   gpu=torch.cuda.get_device_name()
                   if args.device != "cpu" else "cpu")
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


class _Probe:
    """Counts the engine's live requests at the window's start and end."""

    def __init__(self, engine, start, end, out):
        self.engine, self.start, self.end, self.out = engine, start, end, out

    def wants_steps(self):
        return False

    def step(self, fn, now):
        for key, at in (("start", self.start), ("end", self.end)):
            if key not in self.out and now >= at:
                self.out[key] = sum(1 for r in self.engine.requests.values()
                                    if r.state.name != "FINISHED")
        fn()


if __name__ == "__main__":
    bench_run.prepare()
    sys.exit(main())
