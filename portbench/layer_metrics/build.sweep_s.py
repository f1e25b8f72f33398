"""build.sweep_s: device seconds of the RNN-Descent sweeps in one build.

The sum of the ``device_ms`` of the program's ``rnn_descent/sweep`` spans
(``repro_torch.obs``: CUDA events around each sweep) over the traced
window, over the builds the window completed.
"""


def read(t):
    ms = [s["attrs"]["device_ms"] for s in t.spans
          if s["name"] == "rnn_descent/sweep" and "device_ms" in s["attrs"]]
    if not ms or not t.stats.get("builds"):
        return None
    return sum(ms) / 1e3 / t.stats["builds"]
