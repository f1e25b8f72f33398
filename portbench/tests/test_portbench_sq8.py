"""The SQ8 build cell (driver ``build_sq8``) on the CPU at a tiny size: a
cell of the tiny checkout over ``bind("rnnd-ann", "build_gist_sq8",
reduced=True)``, added as new files and entries, runs correct; its control
and each planted fault (an f32 build that skips the codes, one code moved by
two steps, an altered answer) come out not correct; a traced run reads
``quant.encode_s``; a program without the shape stops at ``bind``."""
from __future__ import annotations

import os

import pytest
import torch
from portbench_tiny import ROOT, _dump, make_checkout, run

from portbench.harness import registry

CELL = "tiny_sq8.build"


def add_sq8_cell(bench) -> registry.Bench:
    """``tiny_sq8.build`` added to the tiny checkout ``bench``: the tiny
    configuration bound to the SQ8 shape with ``gist1m_sq8``'s quantization,
    and the ``build_sq8`` mix at the tiny cell's sizes; the metrics that list
    ``gist1m_sq8.build`` list it too."""
    root, bdir = bench.root, bench.bench_dir
    tiny = bench.cell("tiny.build")
    sq8 = registry.load_json(os.path.join(ROOT, "portbench", "configs", "gist1m_sq8.json"))
    cfg = {**tiny.config, "name": "tiny_sq8", "quant": sq8["quant"], "limits": sq8["limits"],
           "bind": {**tiny.config["bind"], "shape": "build_gist_sq8"}}
    _dump(os.path.join(bdir, "configs", "tiny_sq8.json"), cfg)
    mix = registry.load_json(os.path.join(ROOT, "portbench", "traffic", "build_sq8.json"))
    _dump(os.path.join(bdir, "traffic", "tiny_build_sq8.json"),
          {**mix, "search_tile": 256, "check_rows": 4096})
    spec = bench.spec
    spec["configs"].append({"name": "tiny_sq8", "source": "https://arxiv.org/abs/2310.20419",
                            "file": "portbench/configs/tiny_sq8.json", "reduced": [],
                            "why": "t"})
    spec["workloads"].append({"name": CELL, "config": "tiny_sq8", "traffic": "tiny_build_sq8",
                              "chips": 1, "why": "t"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gist1m_sq8.build" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _dump(os.path.join(root, "BENCHMARK.json"), spec)
    return registry.Bench(root, bdir)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return add_sq8_cell(make_checkout(str(tmp_path_factory.mktemp("checkout"))))


def test_sound_run_is_correct(bench):
    out = run(bench, CELL)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"build_s", "recall_at_10", "setup_s"}
    assert out["checks"]["codes_bad"]["value"] == 0
    assert list(out["checks"]) == ["codes_bad", "graph_bad", "graph_dist_err", "answer_bad",
                                   "answer_dist_err", "recall_at_10"]


def test_control_is_not_correct(bench):
    """bf16 gathers over the decoded rows, answers from the codes: both
    distance limits fail, the codes do not."""
    out = run(bench, CELL, precision="bf16")
    assert not out["correct"]
    for name in ("graph_dist_err", "answer_dist_err"):
        c = out["checks"][name]
        assert c["value"] > c["limit"], name
    assert out["checks"]["codes_bad"]["value"] == 0


def test_fault_f32_build_skips_the_codes(bench, monkeypatch):
    """The graph is built over the f32 rows: its distances are not those of
    the index's decoded rows."""
    from repro_torch.core import rnn_descent
    monkeypatch.setattr(rnn_descent, "prep_corpus", lambda x, quant: (x, None))
    out = run(bench, CELL)
    assert not out["correct"]
    c = out["checks"]["graph_dist_err"]
    assert c["value"] > 10 * c["limit"]


def test_fault_one_code_moved_by_two_steps(bench, monkeypatch):
    from repro_torch.quant import quantization
    inner = quantization.encode_corpus

    def moved(x, quant, train_rows=None):
        qx = inner(x, quant, train_rows)
        codes = qx.codes.clone()
        r, j = 17, 5
        codes[r, j] += 2 if int(codes[r, j]) <= 125 else -2
        return qx._replace(codes=codes)
    monkeypatch.setattr(quantization, "encode_corpus", moved)
    out = run(bench, CELL)
    assert not out["correct"] and out["checks"]["codes_bad"]["value"] == 1


def test_fault_search_alters_an_answer(bench, monkeypatch):
    from repro_torch.core import search
    inner = search.search_tiled

    def alter(*a, **kw):
        out = inner(*a, **kw)
        ids = out[0].clone()
        ids[0, 0] = ids[1, 0] if int(ids[1, 0]) not in ids[0].tolist() else ids[1, 5]
        return (ids, *out[1:])
    monkeypatch.setattr(search, "search_tiled", alter)
    out = run(bench, CELL)
    assert not out["correct"] and out["checks"]["answer_dist_err"]["value"] > 1e-3


def test_traced_run_reads_the_encode(bench):
    """On the CPU the encode span's own time is the device's; the sweep
    readers, which need CUDA events, find nothing."""
    out = run(bench, CELL, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"quant.encode_s"}
    assert out["metrics"]["quant.encode_s"]["value"] > 0


def test_a_program_without_the_shape_stops_at_bind(bench, monkeypatch):
    """A program that lacks ``build_gist_sq8`` (as one before it) fails in
    set-up, at ``bind``, before any data is made."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs import rnnd_ann

    from portbench.harness import data
    arch = dataclasses.replace(rnnd_ann.ARCH, shapes=tuple(
        s for s in rnnd_ann.ARCH.shapes if s.name != "build_gist_sq8"))
    monkeypatch.setitem(configs.REGISTRY, "rnnd-ann", arch)
    monkeypatch.setattr(data, "make", lambda *a, **k: pytest.fail("data made before bind"))
    with pytest.raises(KeyError, match="build_gist_sq8"):
        run(bench, CELL)


def test_the_bound_quantization_must_be_the_files(bench, monkeypatch):
    from repro_torch.configs import rnnd_ann
    from repro_torch.quant import Quantization
    monkeypatch.setattr(rnnd_ann, "SQ8", Quantization("int8", rerank_k=32))
    with pytest.raises(ValueError, match="quantization"):
        run(bench, CELL)
