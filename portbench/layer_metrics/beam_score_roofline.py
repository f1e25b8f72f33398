"""beam_score_roofline: the share of its roofline that the ``beam_score``
kernel reached in the profiled calls, in %.

The least time of the lane work those calls expanded (``roofline.
beam_score_work``: bytes once at 3.35 TB/s or operations at 67 TFLOP/s)
over the profiler's ``beam_score`` device time. The valid candidates an
expansion scores are taken as the graph's mean count of valid ids among a
row's first k: no counter of the program gives the expanded rows' own.
"""
from portbench.harness import profile, roofline

BEAM = "beam_score_kernel<"


def read(t):
    s = t.stats
    if t.summary is None or not s.get("profiled_work") or s.get("valid_per_expansion") is None:
        return None
    sec, launches = profile.seconds_of(t.summary, BEAM)
    if not launches or sec <= 0:
        return None
    flops, nbytes = roofline.beam_score_work(s["profiled_work"], launches * s["tile"],
                                             s["valid_per_expansion"], s["k"], s["d"],
                                             s["itemsize"])
    return 100.0 * roofline.least_seconds(flops, nbytes) / sec
