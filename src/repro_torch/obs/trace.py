"""Thread-safe span tracer with Chrome/Perfetto trace-event export (a copy
of ``repro.obs.trace``: the port imports nothing of the JAX package).

One process-wide tracer, off by default. Instrumented code opens spans::

    with trace.span("serving/commit") as sp:
        slots = ann.insert(rows)
        if sp:                       # truthy only while tracing is on
            torch.cuda.synchronize()
            sp.set(kind="insert", n=len(rows))

Contracts (tests/test_obs.py pins each on the reference,
tests/test_torch_serving.py on this copy):

* **Zero-cost when disabled** — :func:`span` performs a single flag check
  and returns a shared no-op singleton: no event is allocated, nothing is
  recorded, ``bool(sp)`` is False so call sites skip attribute computation
  (and any ``torch.cuda.synchronize`` they add for span accuracy). The
  traced and untraced paths launch the *same* kernels, so results are
  bitwise identical either way — tracing may only add host-side reads.
* **Monotonic timestamps** — spans are stamped with ``time.perf_counter``
  relative to the tracer epoch (reset on :func:`reset`), the same clock
  domain the serving front end uses, so retroactive request spans
  (:func:`add_complete`) land on the same timeline.
* **Nesting** — a per-thread stack gives every span its parent and depth;
  the Chrome trace-event export emits complete ("X") events whose
  begin/end nesting Perfetto reconstructs per thread track.
* **On the profiler's clock** — every span opened by :func:`span` also
  opens a ``torch.profiler`` record function of its name, inside the
  span's own interval, so a running ``torch.profiler`` lists it among its
  host events (and can charge what the card waits for to the span).

Exports: :func:`chrome_trace` (load the JSON in https://ui.perfetto.dev),
:func:`summary` / :func:`summary_table` (flat per-name aggregation — the
phase breakdown benchmarks record), :func:`write_chrome_trace`.

This module is the package's timing layer: library code times a block with
:func:`timed` (always measures, records a span when tracing is on) or
accepts a caller-supplied clock, never raw ``time.perf_counter()`` pairs.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any

import torch

_lock = threading.Lock()
_enabled = False
_origin = 0.0                 # perf_counter at the last reset()
_events: list["Span"] = []    # completed spans, append-only under _lock
_tls = threading.local()      # per-thread open-span stack


def _now() -> float:
    return time.perf_counter()


def clock() -> float:
    """The tracer's clock (seconds, monotonic) — same domain as span
    timestamps, for callers that must stamp events themselves."""
    return _now()


class Span:
    """One open (then completed) span. Use as a context manager; attach
    attributes with :meth:`set`. Truthy — the disabled-path sentinel
    :data:`NOOP` is falsy, so ``if sp:`` gates trace-only work."""

    __slots__ = ("name", "t0", "dur_s", "tid", "depth", "attrs", "_rf")

    def __init__(self, name: str, attrs: dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.dur_s = 0.0
        self.tid = 0
        self.depth = 0
        self._rf = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.depth = len(stack)
        self.tid = threading.get_ident()
        stack.append(self)
        self.t0 = _now()
        # the profiler's record function in its fast form (under a microsecond)
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rf.__exit__(exc_type, exc, tb)
        self.dur_s = _now() - self.t0
        stack = getattr(_tls, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()
        with _lock:
            if _enabled:
                _events.append(self)
        return False


class _NoopSpan:
    """Shared disabled-mode sentinel: every method is a no-op, ``bool`` is
    False. One instance for the whole process — ``span()`` allocates
    nothing when tracing is off."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a span (context manager). Single flag check when disabled."""
    if not _enabled:
        return NOOP
    return Span(name, attrs)


def add_complete(name: str, start_s: float, dur_s: float, *,
                 tid: int | None = None, depth: int = 0, **attrs) -> None:
    """Record an already-completed span retroactively (e.g. per-request
    lifecycle segments reconstructed from telemetry timestamps, or compile
    events that arrive as durations). ``start_s`` is in the tracer's clock
    domain (:func:`clock`)."""
    if not _enabled:
        return
    s = Span(name, attrs)
    s.t0 = start_s
    s.dur_s = max(0.0, dur_s)
    s.tid = threading.get_ident() if tid is None else tid
    s.depth = depth
    with _lock:
        if _enabled:
            _events.append(s)


class _Timed:
    """Result handle of :func:`timed` — ``seconds`` is valid after exit."""

    __slots__ = ("name", "attrs", "_t0", "seconds")

    def __init__(self, name: str, attrs: dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self.seconds = 0.0

    def __enter__(self) -> "_Timed":
        self._t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = _now() - self._t0
        if _enabled:
            add_complete(self.name, self._t0, self.seconds, **self.attrs)
        return False


def timed(name: str, **attrs) -> _Timed:
    """Measure a block *unconditionally* (``tm.seconds`` after exit) and
    additionally record it as a span when tracing is on. This is the
    sanctioned replacement for ad-hoc ``time.perf_counter()`` pairs in
    library code."""
    return _Timed(name, attrs)


# ------------------------------------------------------------------ control
def enable() -> None:
    """Turn tracing on (does not clear prior events — see :func:`reset`)."""
    global _enabled, _origin
    with _lock:
        if not _events:
            _origin = _now()
        _enabled = True


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all recorded spans and restart the timeline epoch."""
    global _origin
    with _lock:
        _events.clear()
        _origin = _now()


class enabled_scope:
    """``with trace.enabled_scope():`` — enable tracing inside the block,
    restore the previous state on exit (benchmarks, tests)."""

    def __init__(self, reset_events: bool = True):
        self._reset = reset_events
        self._prev = False

    def __enter__(self):
        self._prev = enabled()
        if self._reset:
            reset()
        enable()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._prev:
            disable()
        return False


# ------------------------------------------------------------------ readout
def events() -> list[dict]:
    """Snapshot of completed spans as plain dicts (seconds, tracer epoch)."""
    with _lock:
        evs, origin = list(_events), _origin
    return [{
        "name": s.name,
        "start_s": s.t0 - origin,
        "dur_s": s.dur_s,
        "tid": s.tid,
        "depth": s.depth,
        "attrs": dict(s.attrs),
    } for s in evs]


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def chrome_trace(process_name: str = "repro_torch") -> dict:
    """The trace as a Chrome/Perfetto trace-event JSON object: complete
    ("X") events, microsecond timestamps relative to the tracer epoch."""
    trace_events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for e in events():
        trace_events.append({
            "name": e["name"],
            "ph": "X",
            "ts": round(e["start_s"] * 1e6, 3),
            "dur": round(e["dur_s"] * 1e6, 3),
            "pid": 1,
            "tid": e["tid"],
            "args": {k: _json_safe(v) for k, v in e["attrs"].items()},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, process_name: str = "repro_torch") -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(process_name), f)


def summary(prefix: str | None = None) -> dict[str, dict]:
    """Flat per-name aggregation: {name: {count, total_s, mean_s, min_s,
    max_s}}, insertion-ordered by first occurrence. ``prefix`` filters by
    span-name prefix."""
    out: dict[str, dict] = {}
    for e in events():
        if prefix is not None and not e["name"].startswith(prefix):
            continue
        row = out.get(e["name"])
        if row is None:
            row = out[e["name"]] = {
                "count": 0, "total_s": 0.0,
                "min_s": float("inf"), "max_s": 0.0,
            }
        row["count"] += 1
        row["total_s"] += e["dur_s"]
        row["min_s"] = min(row["min_s"], e["dur_s"])
        row["max_s"] = max(row["max_s"], e["dur_s"])
    for row in out.values():
        row["mean_s"] = row["total_s"] / row["count"]
    return out


def summary_table(prefix: str | None = None) -> str:
    """The :func:`summary` rendered as an aligned text table."""
    rows = summary(prefix)
    if not rows:
        return "(no spans recorded)"
    name_w = max(len("span"), max(len(n) for n in rows))
    lines = [f"{'span':<{name_w}}  {'count':>6}  {'total_s':>9}  "
             f"{'mean_s':>9}  {'min_s':>9}  {'max_s':>9}"]
    for name, r in rows.items():
        lines.append(
            f"{name:<{name_w}}  {r['count']:>6}  {r['total_s']:>9.4f}  "
            f"{r['mean_s']:>9.4f}  {r['min_s']:>9.4f}  {r['max_s']:>9.4f}")
    return "\n".join(lines)
