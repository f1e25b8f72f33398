"""quant.encode_s: device seconds of a coded build's encode in one build.

The sum of the ``device_ms`` of the program's ``quant/encode`` spans (CUDA
events around ``quant.prep_corpus``: the per-dimension range, the codes and
the decoded corpus, inside ``rnn_descent.build``) over the traced window,
over the builds completed. On a CPU device a span has no CUDA events, and
its own time (``dur_s``) is the device's. A program without the span gives
nothing.
"""


def _ms(s) -> float:
    a = s["attrs"]
    return a["device_ms"] if "device_ms" in a else 1e3 * s["dur_s"]


def read(t):
    ms = [_ms(s) for s in t.spans if s["name"] == "quant/encode"]
    if not ms or not t.stats.get("builds"):
        return None
    return sum(ms) / 1e3 / t.stats["builds"]
