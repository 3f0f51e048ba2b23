"""The check's control on the chip, at a cell's own size: the plain
reference in float8 e4m3 put in the program's place, judged by the same
comparison as a benchmark run (``run.judge`` with ``control``), which has
to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds <s> [--out FILE]

Each seed is one run of the cell (set-up, pre-roll, window) in this
process, its program freed before the reference runs.  One JSON line per
seed: the verdict and the checks as the control's run gives them, and
both readings, the program's widest logit gap and the control's.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[:] = [str(Path(__file__).resolve().parents[1])] + [
    p for p in sys.path
    if Path(p or ".").resolve() != Path(__file__).resolve().parent]

from portbench import run as bench_run  # noqa: E402


def control_run(bench, cell: str, seed: int, seconds: float, device: str):
    """(correct, checks, readings) of the control in one run of ``cell``."""
    w = bench.cell(cell)
    run, _, _, finished = bench_run.serve_cell(
        bench.config(w["config"]), bench.traffic(w["traffic"]), w, [], seed,
        seconds, False, device)
    return bench_run.judge(run, finished, seed, device, control=True)


def main(argv=None) -> int:
    import argparse
    import json

    from portbench.bench import Bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    bench = Bench(bench_run.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, checks, readings = control_run(
            bench, args.workload, seed, args.seconds, args.device)
        line = json.dumps(dict(cell=args.workload, seed=seed,
                               correct=correct, checks=checks, **readings))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    bench_run.prepare()
    sys.exit(main())
