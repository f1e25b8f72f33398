"""Reduction of a ``torch.profiler`` trace to the numbers the benchmark
reports: device busy time (the union of every device operation's
interval), device seconds and counts by operation name, and the idle gaps
between device operations by what the host was doing meanwhile.

The window is the interval of a host marker (``torch.profiler.record_function``
named :data:`MARK`) that the driver opens around the traced work, so the
busy time and the window share the profiler's clock.
"""
from __future__ import annotations

import heapq

MARK = "portbench/window"
TOP = 10


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def events(prof):
    """(device ops, host ops, window) of a finished profiler, each op
    ``(start_us, end_us, name)``; the window is the marker's interval. Read
    from the profiler's raw events: building its event tree takes tens of
    seconds for the hundreds of thousands of ops of a traced search."""
    from torch.autograd import DeviceType
    dev, host, win = [], [], None
    for ev in prof.profiler.kineto_results.events():
        a = ev.start_ns() / 1e3
        span = (a, a + ev.duration_ns() / 1e3, ev.name())
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():     # the marker's copy on the device's track
                dev.append(span)
        elif span[2] == MARK:
            win = span[:2] if win is None else (min(win[0], span[0]), max(win[1], span[1]))
        else:
            host.append(span)
    return dev, host, win


def reduce(dev, host, win) -> dict:
    """Summary of device ops ``dev`` and host ops ``host`` inside the
    window ``win`` = (start_us, end_us): busy and window seconds, device
    seconds and counts by name, kernel count (copies and sets left out), the
    top device ops and the longest idle gaps, each gap charged to the
    innermost host op (latest start) running at its midpoint."""
    w0, w1 = win
    clipped = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1)
    seconds, counts = {}, {}
    for a, b, n in clipped:
        seconds[n] = seconds.get(n, 0.0) + (b - a) / 1e6
        counts[n] = counts.get(n, 0) + 1
    busy, gaps, end = 0.0, [], w0
    for a, b, _ in clipped:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    by_host = {}
    for name, s in _charge(gaps, host):
        by_host[name] = by_host.get(name, 0.0) + s
    top = sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_s": seconds,
        "device_n": counts,
        "kernels": sum(c for n, c in counts.items() if _is_kernel(n)),
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": sorted(([n, s] for n, s in by_host.items()), key=lambda kv: -kv[1])[:TOP],
    }


def _charge(gaps, host):
    """(host op name, gap seconds) for each gap: the op with the latest
    start among those running at the gap's midpoint. One sweep over the
    midpoints in order; an op that ended before a midpoint has ended before
    every later one, so it leaves the heap for good."""
    ops = sorted(host)
    heap, j, out = [], 0, []
    for mid, sec in sorted(((a + b) / 2, (b - a) / 1e6) for a, b in gaps):
        while j < len(ops) and ops[j][0] <= mid:
            heapq.heappush(heap, (-ops[j][0], ops[j][1], ops[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append((heap[0][2] if heap else "host idle", sec))
    return out


def summarize(prof) -> dict:
    dev, host, win = events(prof)
    if win is None:
        raise RuntimeError(f"the profiler saw no {MARK!r} marker")
    return reduce(dev, host, win)


def seconds_of(summary: dict, pattern: str) -> tuple[float, int]:
    """Device seconds and op count of every op whose name contains
    ``pattern``."""
    s = sum(v for n, v in summary["device_s"].items() if pattern in n)
    c = sum(v for n, v in summary["device_n"].items() if pattern in n)
    return s, c


def idle_percent(summary) -> float | None:
    """The share of the window, in %, in which no op ran on the device."""
    if summary is None or summary["window_s"] <= 0 or not summary["device_n"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
