"""A checkout of the benchmark at a size the CPU holds: a copy of
``portbench/`` and ``BENCHMARK.json`` under a temporary root, with a tiny
configuration (n = 4,096, d = 32: ``bind(..., reduced=True)``, the SMOKE
build) and two small mixes added as new files and entries, the way a later
change adds a cell. The drivers, readers and reference are the repository's.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import registry, runner  # noqa: E402

SEED = 2 ** 31 + 12345       # larger than 32 signed bits hold


def tiny_config(base: dict) -> dict:
    cfg = dict(base)
    cfg.update(name="tiny", n=4096, d=32, queries=512,
               bind={"arch": "rnnd-ann", "shape": "build_1m", "reduced": True},
               build={"s": 8, "r": 24, "t1": 2, "t2": 3, "capacity": 32, "metric": "l2",
                      "gram_dtype": "f32", "merge": "bucketed"},
               search={"l": 32, "k": 16, "max_iters": 64, "topk": 10, "visited": "hashed",
                       "metric": "l2", "gram_dtype": "f32", "entry": "centroid_nearest"},
               guarantees={**base["guarantees"], "recall_at_10": 0.7})
    return cfg


def make_checkout(tmp: str) -> registry.Bench:
    """The copy, with cells ``tiny.build`` and ``tiny.search`` added."""
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = registry.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    sift = registry.load_json(os.path.join(ROOT, "portbench", "configs", "sift1m.json"))
    _dump(os.path.join(tmp, "portbench", "configs", "tiny.json"), tiny_config(sift))
    for src, dst, kw in (("build", "tiny_build", {"search_tile": 256, "check_rows": 4096}),
                         ("batch16384", "tiny_b256", {"batch": 256, "pool": 2048, "profile_skip": 1,
                                                     "profile_calls": 2, "check_rows": 1024})):
        mix = registry.load_json(os.path.join(ROOT, "portbench", "traffic", f"{src}.json"))
        _dump(os.path.join(tmp, "portbench", "traffic", f"{dst}.json"), {**mix, **kw})
    spec["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2310.20419",
                            "file": "portbench/configs/tiny.json", "reduced": [],
                            "why": "a CPU-sized stand-in for the tests"})
    spec["workloads"] += [
        {"name": "tiny.build", "config": "tiny", "traffic": "tiny_build", "chips": 1, "why": "t"},
        {"name": "tiny.search", "config": "tiny", "traffic": "tiny_b256", "chips": 1, "why": "t"}]
    like = {"sift1m.build": "tiny.build", "sift1m.search_b16384": "tiny.search"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [like[w] for w in m["workloads"] if w in like]
    _dump(os.path.join(tmp, "BENCHMARK.json"), spec)
    return registry.Bench(tmp, os.path.join(tmp, "portbench"))


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(bench, cell: str, trace: bool = False, precision=None, seconds: float = 0.5,
        seed: int = SEED) -> dict:
    return runner.run_cell(bench, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                           precision=precision)
