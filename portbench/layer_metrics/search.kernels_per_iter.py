"""search.kernels_per_iter: device kernels a beam iteration, by the
profiler's trace of the profiled calls: every kernel (copies and sets left
out) over the ``beam_score`` kernels, one a beam iteration of a call."""
from portbench.harness import profile

BEAM = "beam_score_kernel<"


def read(t):
    if t.summary is None:
        return None
    _, beams = profile.seconds_of(t.summary, BEAM)
    return t.summary["kernels"] / beams if beams else None
