"""The benchmark as data: a cell of ``BENCHMARK.json`` and the files it
names, found by name.

- ``BENCHMARK.json``: the cells (``workloads``), the end-to-end and
  per-layer metrics;
- ``benchmark/configs/<config>.json``: a deployment (its dataset, model,
  precision, source);
- ``benchmark/traffic/<traffic>.json``: a mix (the job kind and the port's
  flags);
- ``benchmark/limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell, with the readings they were set from;
- ``benchmark/metrics/<metric>.py``: one reader a per-layer metric, a
  function ``read(records)``;
- ``benchmark/device/*.json``: published peaks, one file a card.

Adding a cell, a mix, a configuration or a metric adds files and entries;
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name, root=ROOT):
        bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _load_json(os.path.join(root,
                                              self.config_entry["file"]))
        self.traffic = _load_json(self.path("traffic",
                                            self.entry["traffic"] + ".json"))
        self.limits = _load_json(self.path("limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.entry["chips"])

    def path(self, *parts):
        return os.path.join(self.bench_dir, *parts)

    def reader(self, metric):
        """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
        path = self.path("metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def peaks_for(kind, bench_dir=os.path.join(ROOT, "benchmark")):
    """The published peaks of the card named ``kind``, or None."""
    folder = os.path.join(bench_dir, "device")
    for name in sorted(os.listdir(folder)):
        if name.endswith(".json"):
            peaks = _load_json(os.path.join(folder, name))
            if kind in peaks["kinds"]:
                return peaks
    return None
