"""Find a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the file that its ``configs`` entry names
  (``bench/configs/<config>.json``);
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a cell's correctness limits: ``bench/workloads/<cell>.json``;
* a per-layer metric: ``bench/metrics/<metric>.py``, a module whose
  ``read(trace)`` returns the metric's value, or ``None`` where the trace
  holds nothing for it to read.

Adding a configuration, a traffic mix, a cell or a metric is adding its
file and its entry in ``BENCHMARK.json``; no other file changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent


class Cell:
    """One cell: its entry, configuration, traffic, limits and metrics."""

    def __init__(self, name, root=None):
        root = Path(root) if root is not None else BENCH.parent
        self.root = root
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((root / "bench" / "traffic" /
                                   f"{self.entry['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((root / "bench" / "workloads" /
                                  f"{name}.json").read_text())["limits"]

    def end_to_end(self):
        """This cell's end-to-end metric entries."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """This cell's per-layer metric entries."""
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric):
        """The ``read`` function of ``bench/metrics/<metric>.py``."""
        path = self.root / "bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
