"""Aggregate dry-run JSONs into the EXPERIMENTS.md roofline tables.

  PYTHONPATH=src python -m repro.launch.report [--dir experiments/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import roofline_terms


def load_records(d: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}GiB"


def table(recs, multi_pod: bool):
    rows = []
    for r in recs:
        if r.get("multi_pod", False) != multi_pod:
            continue
        if r.get("status", "").startswith("skip"):
            rows.append((r["arch"], r["shape"], r["status"],
                         "", "", "", "", "", "", ""))
            continue
        t = roofline_terms(r)
        rows.append((
            r["arch"], r["shape"], "ok",
            fmt_bytes(r.get("per_device_bytes")),
            f"{t['t_compute_s']:.3f}",
            f"{t['t_memory_opt_s']:.3f}~{t['t_memory_s']:.2f}",
            f"{t['t_collective_s']:.3f}", t["dominant"],
            f"{t['useful_ratio']:.2f}", f"{t['mfu_bound']:.3f}",
        ))
    hdr = ("arch", "shape", "status", "bytes/dev", "t_comp(s)",
           "t_mem(s,opt~pess)", "t_coll(s)", "dominant", "useful", "rl_frac")
    w = [max(len(str(x)) for x in [h] + [row[i] for row in rows])
         for i, h in enumerate(hdr)]
    lines = ["| " + " | ".join(h.ljust(w[i]) for i, h in enumerate(hdr))
             + " |",
             "|" + "|".join("-" * (w[i] + 2) for i in range(len(hdr))) + "|"]
    for row in rows:
        lines.append("| " + " | ".join(str(x).ljust(w[i])
                                       for i, x in enumerate(row)) + " |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    recs = load_records(args.dir)
    print(table(recs, args.multi_pod))


if __name__ == "__main__":
    main()
