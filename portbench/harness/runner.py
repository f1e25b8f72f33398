"""One run of one cell: set-up, the window, the check, the result line.

The result is the last line of standard output, one JSON object::

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}

``metrics`` holds the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``); ``checks`` (last) each number compared
with the reference beside its limit, which also close standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from portbench.harness import registry, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    trace: bool
    data_kind: object = None         # the module that makes the inputs (registry.data_kind)
    precision: str | None = None     # the control: the program's lower-precision path


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    at_most: bool = True             # value <= limit, else value >= limit

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.at_most else self.value >= self.limit


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (Linux: ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def run_cell(bench: registry.Bench, name: str, seed: int, seconds: float, trace: bool,
             device, setup_t0: float, precision: str | None = None) -> dict:
    """Run cell ``name`` and return its result object. ``setup_t0``: the
    ``time.perf_counter()`` reading that ``setup_s`` counts from."""
    cell = bench.cell(name)
    dev = torch.device(device)
    ctx = Ctx(cell.config, cell.traffic, seed, dev, trace,
              bench.data_kind(cell.config["data"]["kind"]), precision)
    driver = cell.driver()
    tracer = tracing.Tracer(trace, dev)
    state = driver.setup(ctx)
    tracer.warm()
    tracing.sync(dev)
    setup_s = time.perf_counter() - setup_t0
    if dev.type == "cuda":         # the window's own peak, not the set-up's build
        torch.cuda.reset_peak_memory_stats(dev)
    win = driver.window(ctx, state, seconds, tracer)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    checks, after = driver.judge(ctx, state)
    failed = after.pop("failed")
    tracer.finish()
    values = {"setup_s": setup_s, **win["values"], **after}
    if trace:
        tracer.stats.update(win.get("stats", {}))
        metrics = {}
        for m in cell.per_layer:
            v = bench.reader(m["name"])(tracer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
        if missing:
            raise RuntimeError(f"{name}: the driver gave no {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": all(c.ok for c in checks), "attempted": win["attempted"],
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace and tracer.summary is not None:
        out["device"]["busy_s"] = tracer.summary["busy_s"]
        out["device"]["window_s"] = tracer.summary["window_s"]
        out["breakdown"] = {"device_ops": tracer.summary["device_ops"],
                            "idle_gaps": tracer.summary["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: str) -> int:
    args = parse(argv)
    setup_t0 = time.perf_counter() - process_age()     # the process's start
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    bench = registry.Bench(root)
    need = bench.cell(args.workload).chips
    if torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", setup_t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
