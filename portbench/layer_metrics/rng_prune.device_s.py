"""rng_prune.device_s: device seconds of the ``rng_prune`` kernels in one
build, by the profiler's trace of the traced window, over the builds
completed."""
from portbench.harness import profile


def read(t):
    if t.summary is None or not t.stats.get("builds"):
        return None
    sec, count = profile.seconds_of(t.summary, "rng_prune")
    return sec / t.stats["builds"] if count else None
