"""device.idle.search: the share of the traced window, in %, in which no
operation ran on the card (the profiler's device ops, their intervals'
union against the window's length)."""
from portbench.harness import profile


def read(t):
    return profile.idle_percent(t.summary)
