"""bucket_merge_roofline: the share of its roofline that the sweep's merge
(on the card the ``bucket_merge`` kernels and the fill of their table)
reached over the traced window, in %.

The least time of the work of the window's merges (the sum, over the
program's ``graph/merge`` spans that give their width ``m`` and a
``device_ms``, of ``roofline.least_seconds`` of :func:`merge_work`) over
the sum of those spans' ``device_ms``: CUDA events around the whole merge,
so the time holds all of its device work. A program whose merge span gives
no ``m`` gives nothing.
"""
from portbench.harness import roofline


def merge_work(a: dict) -> tuple[float, float]:
    """(flops, bytes) of one merge of ``a["rows"]`` rows of ``a["m"]``
    slots: its inputs read once (the rows' ids and distances, the prune's
    keep mask, redirect ids and distances: 17 bytes a slot) and its rows
    written once (id, distance, flag: 9 bytes a slot). No operation is
    counted; a bucket table is the design's own traffic, not the merge's."""
    return 0.0, 26.0 * a["rows"] * a["m"]


def read(t):
    merges = [s["attrs"] for s in t.spans if s["name"] == "graph/merge"
              and "m" in s["attrs"] and "device_ms" in s["attrs"]]
    sec = sum(a["device_ms"] for a in merges) / 1e3
    if sec <= 0:
        return None
    return 100.0 * sum(roofline.least_seconds(*merge_work(a)) for a in merges) / sec
