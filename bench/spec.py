"""Find a cell's files by the names in ``BENCHMARK.json``.

* a configuration: the file that its ``configs`` entry names
  (``bench/configs/<config>.json``);
* a traffic mix: ``bench/traffic/<traffic>.json``;
* a cell's correctness limits: ``bench/workloads/<cell>.json``;
* a per-layer metric: ``bench/metrics/<metric>.py``, a module whose
  ``read(trace)`` returns the metric's value, or ``None`` where the trace
  holds nothing for it to read;
* a model family's program: ``bench/programs/<model.arch>.py``, named by
  the configuration's ``model.arch``. It holds everything that ``run.py``
  and ``calibrate.py`` drive of that family:

  - ``checked(cell, seed, dev) -> (runner, outputs)``: set-up, then the
    checked steps, through the same calls and data that the window uses;
  - the ``runner``: ``runner.unit()`` runs one unit of the window's work
    and returns its losses as a tensor; ``runner.samples_per_unit`` and
    ``runner.steps_per_unit`` give the unit's size; ``runner.free()``
    drops the program's state before the check;
  - ``reference(cell, seed, dev, **fault) -> outputs``: the plain
    reference through the same checked steps, from the same seed;
  - ``numbers(got, want) -> dict``: every reading of the program's
    outputs against the reference's; the cell's limits pick the ones
    they compare;
  - ``FAULTS = {name: kwargs}``: the control and the planted faults,
    each the keyword arguments of ``reference`` that make it.

  The module owns whatever else it needs: its imports of the port, its
  data, its reference.

Adding a configuration, a traffic mix, a cell, a metric or a model family
is adding its files and its entries in ``BENCHMARK.json``; no other file
changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def _load(path, prefix, name):
    """The module in the file ``path``, loaded by path under a name of its
    own, so that a cell's root, and not ``sys.path``, decides which file."""
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its entry, configuration, traffic, limits, metrics and
    program."""

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
        return _load(path, "bench_metric_", metric).read

    def program(self):
        """The module ``bench/programs/<model.arch>.py`` of this cell's
        root; raises ``FileNotFoundError`` naming the arch and the path
        where there is none."""
        arch = self.config["model"]["arch"]
        path = self.root / "bench" / "programs" / f"{arch}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no program module for model.arch "
                                    f"{arch!r}: {path} does not exist")
        return _load(path, "bench_program_", arch)
