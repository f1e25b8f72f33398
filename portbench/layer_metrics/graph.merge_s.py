"""graph.merge_s: device seconds of the candidate merge (``core.graph``) in
one build.

The sum of the ``device_ms`` of the program's ``graph/merge`` spans (CUDA
events around the sort of a sweep's pruned rows and
``merge_candidate_edges``, inside every ``rnn_descent/sweep``) over the
traced window, over the builds the window completed.
"""


def read(t):
    ms = [s["attrs"]["device_ms"] for s in t.spans
          if s["name"] == "graph/merge" and "device_ms" in s["attrs"]]
    if not ms or not t.stats.get("builds"):
        return None
    return sum(ms) / 1e3 / t.stats["builds"]
