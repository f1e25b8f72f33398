"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, the data file
``portbench/traffic/<traffic>.json``. The mix's ``driver`` names the general
driver that runs it (``portbench/drivers/<driver>.py``); the configuration's
``data.kind`` the file that makes its inputs (``portbench/data/<kind>.py``).
A per-layer metric is read by ``portbench/layer_metrics/<metric>.py``.
Adding a configuration, a kind of data, a mix or a metric is adding its file
and its entry: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.traffic['driver']}")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Bench:
    """``BENCHMARK.json`` at ``root``, the files under ``bench_dir``."""

    def __init__(self, root: str, bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> Cell:
        w = {c["name"]: c for c in self.spec["workloads"]}.get(name)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = load_json(os.path.join(self.root, conf["file"]))
        traffic = load_json(os.path.join(self.bench_dir, "traffic", f"{w['traffic']}.json"))
        e2e = [m for m in self.spec["end_to_end"] if _for_cell(m, name)]
        names = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m
                                                       and m["moves"] in names)]
        return Cell(name, w["chips"], config, traffic, e2e, layer)

    def _module(self, folder: str, name: str):
        path = os.path.join(self.bench_dir, folder, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The ``read(trace) -> float | None`` of a per-layer metric."""
        return self._module("layer_metrics", metric).read

    def data_kind(self, kind: str):
        """The module whose ``make`` makes the inputs of data ``kind``."""
        return self._module("data", kind)
