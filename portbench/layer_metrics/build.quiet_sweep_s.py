"""build.quiet_sweep_s: device seconds, in one build, of the sweeps that
accept almost nothing.

The ``device_ms`` of the program's ``rnn_descent/sweep`` spans whose
``edges_new`` (edges the sweep's merge accepted) is under 1 % of their
``edges_live``, over the traced window, over the builds completed: the work
that a merge skipping settled rows would save.
"""

QUIET = 0.01


def read(t):
    sweeps = [s["attrs"] for s in t.spans
              if s["name"] == "rnn_descent/sweep" and "device_ms" in s["attrs"]
              and "edges_new" in s["attrs"]]
    if not sweeps or not t.stats.get("builds"):
        return None
    quiet = [a["device_ms"] for a in sweeps if a["edges_new"] < QUIET * a["edges_live"]]
    return sum(quiet) / 1e3 / t.stats["builds"]
