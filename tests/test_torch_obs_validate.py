"""The port's span-chain validator (``repro_torch.obs.validate``, the
counterpart of ``scripts/validate_obs.py``) on a port ``run(...)`` with
``metrics_out``: the case of ``tests/test_obs.py``'s
``test_gmg_run_metrics_and_trace_complete``, and the validator's verdicts
equal to the reference script's on the same directories, broken ones
included."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)          # parallel test workers share the CPU

from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.obs.validate import main, validate_dir  # noqa: E402
from repro_torch.serving.run import (ExperimentSpec,  # noqa: E402
                                     TelemetrySpec, run)
from repro_torch.serving.workload import WorkloadSpec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPEC = WorkloadSpec(rate=8.0, duration=10.0, seed=1)


@pytest.fixture(scope="module")
def metrics_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    obs, tracer = MetricsRegistry(), Tracer()
    s = run(ExperimentSpec(
        scheduler="gmg", workload=SPEC,
        telemetry=TelemetrySpec(obs=obs, tracer=tracer,
                                metrics_out=str(d))))
    assert obs.value_of("engine_finished_total") == s.n_finished > 0
    assert tracer.incomplete_rids() == set()
    return d


def _reference_verdict(d) -> list:
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import validate_obs
    finally:
        sys.path.pop(0)
    return validate_obs.validate_dir(str(d))


def test_gmg_run_validates(metrics_dir):
    assert validate_dir(str(metrics_dir)) == []
    assert _reference_verdict(metrics_dir) == []
    chrome = json.loads((metrics_dir / "trace_chrome.json").read_text())
    assert any(ev.get("ph") == "X" for ev in chrome["traceEvents"])


def test_broken_chains_fail_as_in_the_reference(metrics_dir, tmp_path):
    lines = (metrics_dir / "trace.jsonl").read_text().splitlines()
    (tmp_path / "metrics.prom").write_text(
        (metrics_dir / "metrics.prom").read_text())
    # drop every terminal event: each admitted chain stays open
    kept = [ln for ln in lines
            if json.loads(ln)["name"] not in ("finish", "shed")]
    kept.append(json.dumps({"name": "bogus", "rid": 1, "t": 0.0,
                            "replica": 0}))
    (tmp_path / "trace.jsonl").write_text("\n".join(kept) + "\n")
    got = validate_dir(str(tmp_path))
    assert got and got == _reference_verdict(tmp_path)
    assert any("never reached a terminal event" in f for f in got)
    assert any("unknown event" in f for f in got)


def test_module_entry_point(metrics_dir):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate",
                        str(metrics_dir)], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all OK" in r.stdout
    assert main([]) == 2
