"""The readers of ``graph.merge_scatter_share`` and ``bucket_merge_roofline``
on hand-built traces, against arithmetic done by hand: the merge spans of a
program that counts its real candidates and gives its merges' width, and of
one that does neither."""
from __future__ import annotations

import pytest
from portbench_tiny import ROOT

from portbench.harness.registry import Bench


class Trace:
    """Two builds of two sweeps; each merge span as the program sets it."""

    def __init__(self, counted: bool = True):
        self.stats = {"builds": 2}
        self.spans = []
        for ms, scattered in ((40.0, 12_800), (30.0, 6_400), (45.0, 12_800), (25.0, 0)):
            attrs = {"device_ms": ms, "rows": 1000, "m": 128, "rows_changed": 500,
                     "launches": 2}
            if counted:
                attrs["cands_scattered"] = scattered
            else:
                del attrs["m"]
            self.spans += [{"name": "graph/merge", "attrs": attrs},
                           {"name": "rnn_descent/sweep", "attrs": {"device_ms": ms + 1.0}}]


def reader(name="graph.merge_scatter_share"):
    return Bench(ROOT).reader(name)


def test_scatter_share_over_the_timed_merges():
    # (12,800 + 6,400 + 12,800 + 0) real candidates over 4 x 1000 x 128 slots
    t = Trace()
    assert reader()(t) == pytest.approx(32_000 / 512_000)
    # a merge with no device time (the CPU's) is not among graph.merge_s's
    t.spans.append({"name": "graph/merge",
                    "attrs": {"rows": 1000, "m": 128, "rows_changed": 9, "cands_scattered": 9}})
    assert reader()(t) == pytest.approx(32_000 / 512_000)


def test_scatter_share_needs_the_count():
    assert reader()(Trace(counted=False)) is None     # a program without the counter
    t = Trace()
    t.spans = [s for s in t.spans if s["name"] != "graph/merge"]
    assert reader()(t) is None


def test_merge_roofline_by_hand():
    # 4 merges of 1000 x 128 slots at 26 bytes: 13.312e6 bytes -> 3.9737e-6 s
    # over the spans' (40 + 30 + 45 + 25) ms
    t = Trace()
    assert reader("bucket_merge_roofline")(t) == pytest.approx(
        100 * 13.312e6 / 3.35e12 / 0.140)
    assert reader("bucket_merge_roofline")(t) == pytest.approx(0.0028384, rel=1e-4)
    # a merge with no device time (the CPU's) is not counted
    t.spans.append({"name": "graph/merge", "attrs": {"rows": 1000, "m": 128}})
    assert reader("bucket_merge_roofline")(t) == pytest.approx(0.0028384, rel=1e-4)


def test_merge_roofline_needs_the_width():
    assert reader("bucket_merge_roofline")(Trace(counted=False)) is None   # no "m"
    t = Trace()
    t.spans = [s for s in t.spans if s["name"] != "graph/merge"]
    assert reader("bucket_merge_roofline")(t) is None
