"""Whole runs on the CPU at a tiny size (the harness's look for a card
skipped): a sound run comes out correct; the control (the program's own
bf16 path) and each fault planted under the timed path come out not
correct; a cell, a mix and a metric added as new files run with no edit to
an existing one. The card test runs ``run.py`` itself."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from portbench_tiny import ROOT, make_checkout, run


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("cell", ["tiny.build", "tiny.search"])
def test_sound_run_is_correct(bench, cell):
    out = run(bench, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in bench.cell(cell).end_to_end}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny.build", "tiny.search"])
def test_control_is_not_correct(bench, cell):
    """The configuration's limits hold against the control at this size."""
    out = run(bench, cell, precision="bf16")
    assert not out["correct"]
    assert out["checks"]["answer_dist_err"]["value"] > out["checks"]["answer_dist_err"]["limit"]
    if cell == "tiny.build":
        c = out["checks"]["graph_dist_err"]
        assert c["value"] > c["limit"]


def _altered(fn, at):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        return at(out)
    return wrapped


def test_fault_build_returns_its_state_unchanged(bench, monkeypatch):
    from repro_torch.core import rnn_descent
    monkeypatch.setattr(rnn_descent, "update_neighbors", lambda x, g, cfg, qx=None: g)
    out = run(bench, "tiny.build")
    assert not out["correct"]
    assert out["checks"]["recall_at_10"]["value"] < out["checks"]["recall_at_10"]["limit"]


def test_fault_build_alters_an_edge(bench, monkeypatch):
    from repro_torch.core import rnn_descent

    def alter(g):
        nb = g.neighbors.clone()
        nb[0, 0] = nb[1, 0] if int(nb[1, 0]) != 0 else nb[2, 0]
        return g._replace(neighbors=nb)
    monkeypatch.setattr(rnn_descent, "build_jit", _altered(rnn_descent.build_jit, alter))
    out = run(bench, "tiny.build")
    assert not out["correct"] and out["checks"]["graph_dist_err"]["value"] > 1e-3


def test_fault_search_alters_an_answer(bench, monkeypatch):
    from repro_torch.core import search

    def alter(out):
        ids = out[0].clone()
        ids[0, 0] = ids[1, 0] if int(ids[1, 0]) not in ids[0].tolist() else ids[1, 5]
        return (ids, *out[1:])
    monkeypatch.setattr(search, "search_tiled", _altered(search.search_tiled, alter))
    out = run(bench, "tiny.search")
    assert not out["correct"] and out["checks"]["answer_dist_err"]["value"] > 1e-3


def test_fault_search_leaves_out_half_the_batch(bench, monkeypatch):
    """The second half of each batch gets the first half's answers."""
    from repro_torch.core import search
    inner = search.search_tiled

    def half(x, g, q, *a, **kw):
        h = q.shape[0] // 2
        out = inner(x, g, q[:h], *a, **kw)
        return (torch.cat([out[0], out[0][: q.shape[0] - h]]),
                torch.cat([out[1], out[1][: q.shape[0] - h]]), *out[2:])
    monkeypatch.setattr(search, "search_tiled", half)
    out = run(bench, "tiny.search")
    assert not out["correct"]
    assert out["checks"]["recall_at_10"]["value"] < 0.6


def test_traced_runs_read_their_layers(bench):
    out = run(bench, "tiny.build", trace=True)
    assert out["correct"]
    # on the CPU the sweeps' spans carry no device_ms and the profiler no
    # device op: those readers find nothing, and their metrics stay out
    assert out["metrics"] == {}
    s = run(bench, "tiny.search", trace=True)
    assert 0 < s["metrics"]["search.lane_efficiency"]["value"] <= 1
    assert "beam_score_roofline" not in s["metrics"]
    assert set(s["device"]) >= {"busy_s", "window_s"} and "breakdown" in s


def test_a_new_cell_mix_and_metric_are_only_new_files(bench):
    """A configuration, a kind of data, a mix and a per-layer metric added as
    files and entries: nothing that was there is edited."""
    root, bdir = bench.root, bench.bench_dir
    with open(os.path.join(bdir, "data", "tiny_blobs.py"), "w") as f:
        f.write("import torch\n\n\ndef make(spec, n, d, queries, seed, device):\n"
                "    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)\n"
                "    c = 5 * torch.randn((16, d), generator=g, device=device)\n"
                "    pick = torch.randint(0, 16, (n + queries,), generator=g, device=device)\n"
                "    x = c[pick] + torch.randn((n + queries, d), generator=g, device=device)\n"
                "    return x[:n], x[n:]\n")
    with open(os.path.join(bdir, "configs", "tiny_blobs.json"), "w") as f:
        json.dump({**bench.cell("tiny.search").config, "name": "tiny_blobs",
                   "data": {"kind": "tiny_blobs"}}, f)
    with open(os.path.join(bdir, "traffic", "tiny_b512.json"), "w") as f:
        json.dump({**bench.cell("tiny.search").traffic, "batch": 512, "pool": 1024}, f)
    with open(os.path.join(bdir, "layer_metrics", "search.calls.py"), "w") as f:
        f.write("def read(t):\n    return float(t.stats['work'] > 0)\n")
    spec = bench.spec
    spec["configs"].append({"name": "tiny_blobs", "source": "https://arxiv.org/abs/2310.20419",
                            "file": "portbench/configs/tiny_blobs.json", "reduced": [],
                            "why": "t"})
    spec["workloads"].append({"name": "tiny.search_b512", "config": "tiny_blobs",
                              "traffic": "tiny_b512", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "search.calls", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "core.search",
                              "moves": "search_qps", "workloads": ["tiny.search_b512"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("search_qps", "search_p90_ms", "recall_at_10"):
            m["workloads"].append("tiny.search_b512")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    from portbench.harness.registry import Bench
    fresh = Bench(root, bdir)
    out = run(fresh, "tiny.search_b512", trace=True)
    assert out["correct"] and out["attempted"] % 512 == 0, out["checks"]
    assert out["metrics"]["search.calls"]["value"] == 1.0


@pytest.mark.cuda
def test_run_py_on_the_card(tmp_path):
    """``run.py`` as the driver runs it, one short build cell, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sift1m.build",
                          "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
