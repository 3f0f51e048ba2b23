"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
file, its traffic file and the reader of each metric.

- configuration: the file the ``configs`` entry names
  (``portbench/configs/<name>.json``);
- traffic: ``portbench/traffic/<traffic>.json``;
- metric: ``portbench/metrics/<metric name>.py``, a module with
  ``read(run)`` that returns the metric's value, or None when the run
  holds nothing to read it from (the metric is then left out).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

from portbench import traffic


class Bench:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = Path(__file__).resolve().parent

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return traffic.load(self.pkg / "traffic" / f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones with
        ``trace`` off, the per-layer ones with it on."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.pkg / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
