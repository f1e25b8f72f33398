"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""
from __future__ import annotations

import json
import os
import re

import pytest
from portbench_tiny import ROOT

from portbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits(spec):
    assert set(spec) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch") and p.rstrip("/") != "benchmarks"
    script = spec["command"][1]
    assert any(script.startswith(p.rstrip("/") + "/") for p in spec["paths"])
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(spec["configs"]) <= 24 and 1 <= len(spec["workloads"]) <= 24
    assert 1 <= len(spec["end_to_end"]) <= 16 and 1 <= len(spec["per_layer"]) <= 128


@pytest.mark.parametrize("kind", ["config", "workload", "end_to_end", "per_layer"])
def test_entries(spec, kind):
    entries = spec[{"config": "configs", "workload": "workloads"}.get(kind, kind)]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) <= KEYS[kind] and set(e) >= KEYS[kind] - {"workloads"}, e
        assert NAME.match(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert _line(e["layer"])
        if kind in ("config", "workload"):
            assert _line(e["why"])
        if kind == "config":
            assert _line(e["source"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
        if kind == "workload":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)


def test_metric_names_unique_and_setup(spec):
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves(spec):
    bench = registry.Bench(ROOT)
    cells = [w["name"] for w in spec["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in spec["paths"])
        cfg = registry.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and callable(bench.data_kind(cfg["data"]["kind"]).make)
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(cells) // 4)
    for name in cells:
        cell = bench.cell(name)
        assert cell.driver().window and cell.driver().judge and cell.driver().setup
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])
            assert callable(bench.reader(m["name"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_config_files_hold_what_is_run(spec):
    for c in spec["configs"]:
        cfg = registry.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for key in ("n", "d", "queries", "bind", "build", "search", "guarantees", "limits",
                    "assumed"):
            assert key in cfg, (c["name"], key)
        assert cfg["build"]["gram_dtype"] == "f32" and cfg["search"]["gram_dtype"] == "f32"
