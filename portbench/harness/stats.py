"""Arithmetic of the end-to-end metrics (plain Python): a rate is taken
over all the work and all the time of a window, a tail over every call."""
from __future__ import annotations

import math


def rate(count: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values, p: float) -> float:
    """The ``p``-th percentile of every value, linear between closest ranks
    (numpy's default): p = 95 over 200 calls lies between the 190th and
    191st smallest."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
