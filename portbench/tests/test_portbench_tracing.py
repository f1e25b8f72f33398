"""The readers of the program's sweep spans (``graph/merge``,
``rng_prune/rows``) on a hand-built trace, against arithmetic done by hand,
and on the CPU, where no ``rng_prune`` kernel runs."""
from __future__ import annotations

import pytest
import torch
from portbench_tiny import ROOT, make_checkout, run

from portbench.harness.registry import Bench


class Trace:
    """The reader's view of a traced window: two builds of two sweeps."""

    def __init__(self, prune_s: float = 0.002):
        self.stats = {"builds": 2}
        self.summary = {"device_s": {"void rng_prune_kernel<float, 4>": prune_s,
                                     "scatter_gather": 1.0},
                        "device_n": {"void rng_prune_kernel<float, 4>": 4, "scatter_gather": 8}}
        prune = {"rows": 1000, "m": 128, "d": 128, "itemsize": 4, "launches": 1}
        self.spans = []
        for ms, valid, sq, changed in ((40.0, 20_000, 400_000, 1000), (30.0, 50_000, 2_600_000, 600),
                                       (45.0, 20_000, 400_000, 990), (25.0, 50_000, 2_600_000, 10)):
            self.spans += [
                {"name": "rng_prune/rows",
                 "attrs": {**prune, "device_ms": 0.5, "cands_valid": valid, "cands_valid_sq": sq}},
                {"name": "graph/merge", "attrs": {"device_ms": ms, "rows": 1000,
                                                  "rows_changed": changed}},
                {"name": "rnn_descent/sweep", "attrs": {"device_ms": ms + 0.6}}]


def reader(name):
    return Bench(ROOT).reader(name)


def test_merge_seconds_a_build():
    # (40 + 30 + 45 + 25) ms over 2 builds
    assert reader("graph.merge_s")(Trace()) == pytest.approx(0.070)


def test_merge_row_yield_over_the_timed_merges():
    t = Trace()
    assert reader("graph.merge_row_yield")(t) == pytest.approx(2600 / 4000)
    # a merge with no device time (the CPU's) is not among graph.merge_s's
    t.spans.append({"name": "graph/merge", "attrs": {"rows": 1000, "rows_changed": 1000}})
    assert reader("graph.merge_row_yield")(t) == pytest.approx(2600 / 4000)
    t.spans = [s for s in t.spans if "device_ms" not in s["attrs"]]
    assert reader("graph.merge_row_yield")(t) is None
    assert reader("graph.merge_s")(t) is None


def test_prune_roofline_by_hand():
    # sweep a (v = 20 a row): flops 128 x (400,000 + 20,000) = 53.76e6 -> 0.8024e-6 s;
    #   bytes (512 + 5) x 20,000 + 13 x 128 x 1000 = 12.004e6 -> 3.5833e-6 s (bytes)
    # sweep b (v = 50): flops 128 x 2,650,000 = 339.2e6 -> 5.0627e-6 s (operations);
    #   bytes 517 x 50,000 + 1.664e6 = 27.514e6 -> 8.2131e-6 s (bytes)
    a = max(53.76e6 / 67e12, 12.004e6 / 3.35e12)
    b = max(339.2e6 / 67e12, 27.514e6 / 3.35e12)
    assert a == pytest.approx(3.5833e-6, rel=1e-4) and b == pytest.approx(8.2131e-6, rel=1e-4)
    read = reader("rng_prune_roofline")
    assert read(Trace(prune_s=0.002)) == pytest.approx(100 * 2 * (a + b) / 0.002)
    assert read(Trace(prune_s=0.004)) == pytest.approx(100 * 2 * (a + b) / 0.004)


def test_prune_roofline_needs_the_kernel_and_the_spans():
    read = reader("rng_prune_roofline")
    t = Trace()
    t.summary = None
    assert read(t) is None
    t = Trace()
    t.summary = {"device_s": {"scatter_gather": 1.0}, "device_n": {"scatter_gather": 8}}
    assert read(t) is None                      # no rng_prune kernel ran
    t = Trace()
    t.spans = [s for s in t.spans if s["name"] != "rng_prune/rows"]
    assert read(t) is None                      # a program without the spans


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


def test_on_the_cpu_the_prune_roofline_stays_out(bench, monkeypatch):
    """The tiny build traced on the CPU: its prune spans carry their counts,
    but no ``rng_prune`` kernel runs, so the reader finds no time."""
    from portbench.harness import tracing
    seen = []
    finish = tracing.Tracer.finish

    def keep(self):
        finish(self)
        seen.append(self)
    monkeypatch.setattr(tracing.Tracer, "finish", keep)
    out = run(bench, "tiny.build", trace=True)
    assert out["correct"]
    assert "rng_prune_roofline" not in out["metrics"]
    (t,) = seen
    prunes = [s["attrs"] for s in t.spans if s["name"] == "rng_prune/rows"]
    assert prunes and all(a["cands_valid"] > 0 for a in prunes)
    assert t.summary["device_n"] == {}
    assert bench.reader("rng_prune_roofline")(t) is None
