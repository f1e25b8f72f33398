"""graph.merge_row_yield: the share of the rows a merge rewrote that came
out changed.

The sum of the ``rows_changed`` (rows holding an edge flagged NEW after the
merge) of the program's ``graph/merge`` spans over the sum of their
``rows`` (rows the merge rewrote: every row, for the bucketed merge), over
the merges that ``graph.merge_s`` times (those with a ``device_ms``), so
the two read one set of merges.
"""


def read(t):
    merges = [s["attrs"] for s in t.spans
              if s["name"] == "graph/merge" and "device_ms" in s["attrs"]
              and "rows_changed" in s["attrs"]]
    rows = sum(a["rows"] for a in merges)
    return sum(a["rows_changed"] for a in merges) / rows if rows else None
