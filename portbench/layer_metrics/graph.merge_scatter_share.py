"""graph.merge_scatter_share: the share of the candidate slots a merge is
offered that are real candidates, the ones that issue an atomic into the
bucket table.

The sum of the ``cands_scattered`` (the real candidates: redirect w in
[0, n), target v >= 0, w != v, distance not NaN) of the program's
``graph/merge`` spans over the sum of their ``rows`` x ``m`` (every (row,
slot) of the pruned graph offers one), over the merges that
``graph.merge_s`` times (those with a ``device_ms``). A program whose merge
span has no ``cands_scattered`` gives nothing.
"""


def read(t):
    merges = [s["attrs"] for s in t.spans
              if s["name"] == "graph/merge" and "device_ms" in s["attrs"]
              and "cands_scattered" in s["attrs"] and "m" in s["attrs"]]
    slots = sum(a["rows"] * a["m"] for a in merges)
    return sum(a["cands_scattered"] for a in merges) / slots if slots else None
