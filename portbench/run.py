"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (timed as ``setup_s``, from the
start of this process): import torch, build or load the paged attention
kernel, build the serving stack from the seed, warm up the cell's shapes,
serve the traffic's pre-roll.  Then the window: ``--seconds`` of the same
traffic (open or closed loop), served in real time.  A traced run then
serves on for a profiled stretch after the window.  Then, with the
program's state freed, the check of what it served against the plain
reference.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (requests due in the window), ``failed`` (requests that
errored), ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, for the record ``generator`` (how
late requests were taken in), ``window`` (the window's counts, latencies
and steps), ``kv`` (KV pages in use against those reserved), with
``--trace 1`` a ``breakdown`` and the profiled stretch's ``profile``, and
last ``checks``: each number compared beside its limit, also printed as
the last lines of standard error.

Exits with code 2 and prints no result when CUDA is absent or holds fewer
cards than the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare() -> None:
    """Paths and environment of a run, before torch is imported."""
    # the checkout's root and the program's sources, and not this folder:
    # its module names would shadow others
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))
    # the weights' float32 draws and the page pool are freed and taken in
    # turn; segments that grow keep them from fragmenting the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ.setdefault("USE_FLAX", "0")


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """Everything a metric reader may read from one run: ``cfg``,
    ``traffic``, ``cell``, ``records`` (one per request), the window's
    ``start`` and ``end`` (seconds from the traffic's ``origin``, a
    ``time.perf_counter`` reading), ``setup_s``, ``device`` ("cuda" or
    "cpu"), ``steps`` (``serve.Served.steps``), ``pages`` (the KV pages
    reserved), and in a traced run ``tracer`` and ``profile``
    (``tracer.Tracer.finish``)."""

    def __init__(self, **kw):
        self.tracer = self.profile = None
        self.__dict__.update(kw)


def forbidden_modules(modules=None):
    """The forbidden packages among ``modules`` (default: the loaded
    ones), compared by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def serve_cell(cfg, t, cell, metrics, seed: int, seconds: float,
               trace: bool, device: str):
    """Set up, serve the pre-roll and the window, read ``metrics`` (pairs
    of a ``BENCHMARK.json`` metric entry and its reader); then free the
    program.  Returns (Run, metrics dict, device dict, served tokens of the
    finished requests)."""
    import torch

    from portbench import serve, tracer as tracer_mod, traffic

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        from repro_torch.kernels import build
        build.build(["paged_attention"])
    served = serve.Served(cfg, t, seed, device)
    served.warm()
    specs, start, end = traffic.generate(t, seed, seconds,
                                         cfg["vocab_size"])
    tr = tracer_mod.Tracer(served, start, end) if trace else None
    origin = {}
    # what set-up built stays out of the collector's scans, as a server
    # freezes it after start-up
    gc.collect()
    gc.freeze()
    records = served.serve(specs, end, tr,
                           on_origin=lambda o: origin.setdefault("t", o))
    gc.unfreeze()
    run = Run(cfg=cfg, traffic=t, cell=cell, records=records, start=start,
              end=end, seconds=seconds, device=dev.type, origin=origin["t"],
              setup_s=origin["t"] + start - T_START, tracer=tr,
              steps=served.steps, pages=served.backend.num_blocks)
    if tr is not None:
        run.profile = tr.finish()
    info = device_info(dev)
    if run.profile is not None and dev.type == "cuda":
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["window_s"]
    values = {}
    for m, read in metrics:
        value = read(run)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    finished = served.served_tokens(records)
    served.close()
    del served
    if tr is not None:
        tr.be = None        # the backend's memory goes before the check
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run, values, info, finished


def judge(run, finished, seed: int, device: str, control: bool = False):
    """(correct, checks, readings): the served tokens against the
    reference.  With ``control`` the float8 reference's first tokens are
    judged in the program's place (``check.gaps``); ``readings`` holds
    both widest gaps then."""
    from portbench import check

    cfg = run.cfg
    want = cfg["check"]["sample_tokens"]
    picked = check.sample(finished, seed, want)
    readings = check.gaps(cfg, seed, picked, device, control=control) \
        if picked else {}
    gap = readings.get("control" if control else "program")
    limit = cfg["check"]["max_logit_gap"]
    n_tok = sum(len(p[2]) for p in picked)
    n_bad = wrong_lengths(finished, run.records)
    checks = {
        "max_logit_gap": {"value": gap, "limit": limit},
        "wrong_length_streams": {"value": n_bad, "limit": 0},
        "tokens_compared_at_least": {"value": n_tok, "limit": want},
    }
    correct = (gap is not None and gap <= limit and n_bad == 0
               and n_tok >= want)
    return correct, checks, readings


def wrong_lengths(finished, records) -> int:
    """Finished requests whose served stream is not its output length."""
    want = {r.spec.index + 1: r.spec.output_len for r in records}
    return sum(1 for rid, _, out in finished if len(out) != want[rid])


def breakdown(profile) -> dict:
    ops = sorted(profile["ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(profile["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def generator_lag(run) -> dict:
    """How late the engine took in the window's requests: from due to the
    step that admitted them, in ms."""
    from portbench import slo

    lag = [(r.admitted - r.due) * 1e3
           for r in slo.window(run.records, run.start, run.end)
           if r.admitted is not None]
    return {"late_p50_ms": slo.pctl(lag, 50), "late_p95_ms": slo.pctl(lag, 95),
            "late_max_ms": max(lag) if lag else None}


def window_summary(run) -> dict:
    """Counts behind the metrics, the latencies and rates that are not
    this cell's end-to-end metrics (read in every run, for the record),
    and the engine's steps inside the window on the host's clock."""
    from portbench import slo

    win = slo.window(run.records, run.start, run.end)
    met, judged, censored = slo.attainment(run.records, run.start, run.end)
    ttft = slo.ttfts(run.records, run.start, run.end)
    tbt = slo.tbts(run.records, run.start, run.end)
    steps = [s for s in run.steps if run.start <= s[0] < run.end]
    busy = sum(s[1] - s[0] for s in steps)

    def ms(x):
        return None if x is None else x * 1e3

    return {"requests": len(win),
            "streaming": sum(r.spec.kind == "latency" for r in win),
            "met": met, "censored": censored, "gaps": len(tbt),
            "goodput_tok_s": slo.goodput_tok_s(run.records, run.start,
                                               run.end),
            "output_tok_s": slo.output_tok_s(run.records, run.start,
                                             run.end),
            "ttft_p50_ms": ms(slo.pctl(ttft, 50)),
            "ttft_p90_ms": ms(slo.pctl(ttft, 90)),
            "tbt_p50_ms": ms(slo.pctl(tbt, 50)),
            "tbt_p95_ms": ms(slo.pctl(tbt, 95)),
            "tbt_mean_ms": ms(sum(tbt) / len(tbt)) if tbt else None,
            "steps": len(steps),
            "step_ms_mean": ms(busy / len(steps)) if steps else None,
            "serving_s": busy,
            "tokens_per_step": (sum(s[2] for s in steps) / len(steps)
                                if steps else None)}


def kv_pages(run) -> dict:
    """The KV pool: pages reserved, and the most in use at the end of a
    step of the window.  ``memory_peak_bytes`` counts the whole pool."""
    used = [s[3] for s in run.steps if run.start <= s[0] < run.end]
    return {"pages_reserved": run.pages,
            "pages_used_peak": max(used) if used else 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) or cpu (the CPU tests)")
    args = ap.parse_args(argv)

    import torch

    from portbench import slo
    from portbench.bench import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if args.device != "cpu":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    device = "cuda:0" if args.device != "cpu" else "cpu"
    metrics = [(m, bench.reader(m["name"]))
               for m in bench.metrics(args.workload, bool(args.trace))]
    run, values, info, finished = serve_cell(
        bench.config(cell["config"]), bench.traffic(cell["traffic"]), cell,
        metrics, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 2
    correct, checks, _ = judge(run, finished, args.seed, device)
    result = {"correct": correct,
              "attempted": len(slo.window(run.records, run.start, run.end)),
              "failed": 0, "metrics": values, "device": info,
              "generator": generator_lag(run), "window": window_summary(run),
              "kv": kv_pages(run)}
    if run.profile is not None:
        result["breakdown"] = breakdown(run.profile)
        result["profile"] = {k: run.profile[k] for k in (
            "busy_s", "window_s", "steps")}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    prepare()
    sys.exit(main())
