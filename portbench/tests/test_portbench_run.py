"""A tiny run of the harness on the CPU, from a checkout that holds only
``BENCHMARK.json`` and the benchmark's folder: a configuration, a traffic
mix and a metric added as files are found by name, and the last line is
the contract's JSON object."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
DATA = PKG / "tests" / "data"

# per-layer metrics read from the device's trace or CUDA events alone
DEVICE_ONLY = {"model.decode_mfu", "model.prefill_mfu",
               "kernel.paged_decode_roofline", "device.idle_frac"}

METRIC = '''"""Requests due in the window (a throwaway metric of the tests)."""

from portbench import slo


def read(run):
    return len(slo.window(run.records, run.start, run.end))
'''


def _checkout(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(DATA / "tiny.json", root / "portbench" / "configs")
    shutil.copy(DATA / "tiny_chat.json", root / "portbench" / "traffic")
    (root / "portbench" / "metrics" / "tiny.requests_due.py").write_text(
        METRIC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(name="tiny", source="tests",
                             file="portbench/configs/tiny.json", reduced=[],
                             why="tests")]
    bench["workloads"] = [dict(name="tiny.chat", config="tiny",
                               traffic="tiny_chat", chips=1, why="tests")]
    # the tiny cell reports what the chat cells report
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "nemo12b.chat" in m.get("workloads", ["nemo12b.chat"]) \
                and "workloads" in m:
            m["workloads"].append("tiny.chat")
    bench["end_to_end"].append(dict(
        name="tiny.requests_due", unit="requests", better="higher",
        bound=0.25, source="host_clock", workloads=["tiny.chat"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root: Path, *extra, src=True):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    if src:
        env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiny.chat",
         "--seed", str(2**31 + 7), "--seconds", "5", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_contract_line(tmp_path, trace):
    root = _checkout(tmp_path)
    out = _run(root, "--trace", str(trace), "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = set(line["metrics"])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if "tiny.chat" in m.get("workloads", ["tiny.chat"])}
    if trace:
        # the per-layer metrics a CPU run can read; the device's are left
        # out, not written as 0
        assert names == want - DEVICE_ONLY
        assert "engine.host_ms_per_step" in names
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == want and "tiny.requests_due" in names
        assert line["metrics"]["tiny.requests_due"]["value"] \
            == line["attempted"]
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    gap = line["checks"]["max_logit_gap"]
    assert gap["value"] <= gap["limit"]
    assert "check max_logit_gap" in out.stderr.strip().splitlines()[-3]


def test_refuses_without_cuda_and_without_the_program(tmp_path):
    import torch

    root = _checkout(tmp_path)
    if not torch.cuda.is_available():
        out = _run(root, "--trace", "0")
        assert out.returncode != 0 and not out.stdout.strip()
    # a checkout of BENCHMARK.json and the benchmark's folder alone
    out = _run(root, "--trace", "0", "--device", "cpu", src=False)
    assert out.returncode != 0 and not out.stdout.strip()


def test_closed_loop_keeps_its_clients_busy(tmp_path):
    from portbench import run as bench_run, slo, traffic

    (tmp_path / "tiny_chat.json").write_text((DATA / "tiny_chat.json")
                                             .read_text())
    (tmp_path / "closed.json").write_text(json.dumps(
        {"extends": "tiny_chat", "arrival": "closed", "clients": 4}))
    cfg = json.loads((DATA / "tiny.json").read_text())
    t = traffic.load(tmp_path / "closed.json")
    seed = 2**31 + 21
    run, _, _, finished = bench_run.serve_cell(
        cfg, t, {"name": "tiny.closed"}, [], seed, 3.0, False, "cpu")
    taken = sorted((r for r in run.records if r.due is not None),
                   key=lambda r: (r.due, r.spec.index))
    # the first four at the origin, each later one when another finished
    assert [r.due for r in taken[:4]] == [0.0] * 4
    ends = sorted(r.stamps[-1] for r in run.records
                  if r.finished or r.shed)
    for k, r in enumerate(taken[4:]):
        assert r.due == ends[k]
    # never more than four requests taken up and unfinished
    for s in run.steps:
        assert sum(1 for r in taken if r.due <= s[0]
                   and not (r.stamps and len(r.stamps) >= r.spec.output_len
                            and r.stamps[-1] <= s[0])) <= 4
    assert slo.window(run.records, run.start, run.end)
    assert bench_run.judge(run, finished, seed, "cpu")[0]
