"""rng_prune_roofline: the share of its roofline that the ``rng_prune``
kernel reached over the traced window, in %.

The least time of the work of the window's prunes (the sum, over the
program's ``rng_prune/rows`` spans, of ``roofline.least_seconds`` of
:func:`prune_work`) over the profiler's ``rng_prune`` device seconds in the
same window.
"""
from portbench.harness import profile, roofline

PRUNE = "rng_prune"


def prune_work(a: dict) -> tuple[float, float]:
    """(flops, bytes) of one prune over ``a["rows"]`` rows of capacity
    ``a["m"]``: a row of v valid candidates takes v(v + 1) d operations
    (its pair distances and norms) and reads v rows of d elements of
    ``a["itemsize"]`` bytes and the distance and flag of its v valid slots
    (5 bytes each); every slot reads its id and writes its keep, redirect
    id and distance, 13 bytes. ``cands_valid`` and ``cands_valid_sq`` are
    the sums of v and v^2 over the rows.

    The kernel reads the 5 bytes for each slot up to a row's last valid one
    (its extent e), so this is PERF.md's kernel-table bound with e = v: it
    holds where the valid slots lead every row, as a build's sweeps keep
    them (each merge emits its rows sorted, invalid slots last). A row with
    holes (a compacted store's) would be charged too few bytes."""
    v, v2 = a["cands_valid"], a["cands_valid_sq"]
    flops = a["d"] * (v2 + v)
    nbytes = (a["itemsize"] * a["d"] + 5.0) * v + 13.0 * a["m"] * a["rows"]
    return float(flops), float(nbytes)


def read(t):
    if t.summary is None:
        return None
    sec, launches = profile.seconds_of(t.summary, PRUNE)
    prunes = [s["attrs"] for s in t.spans
              if s["name"] == "rng_prune/rows" and "cands_valid" in s["attrs"]]
    if not launches or sec <= 0 or not prunes:
        return None
    least = sum(roofline.least_seconds(*prune_work(a)) for a in prunes)
    return 100.0 * least / sec
