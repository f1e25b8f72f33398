"""Adapters from the CUDA side of the port into the obs registry and trace
(the port's counterpart of ``repro.obs.jaxhooks``).

Three capture surfaces:

* **Kernel builds** — :func:`install` registers one process-lifetime
  listener with ``kernels/_build`` (idempotent; the listener gates itself
  on ``trace.enabled()``). Each ``nvcc`` run of ``_build.build_all`` lands
  as a ``kernel_builds_total{source=...}`` counter, a
  ``kernel_build_seconds`` histogram and a ``kernel/build`` complete event
  on a track of its own (``KERNEL_TRACK_TID``, as the reference puts its
  ``jax/*`` compile events on a track of their own); each library
  ``_build.load`` opens bumps ``kernel_libs_loaded_total``. A build is the
  port's compile: :func:`kernel_builds` and :func:`kernel_libs_loaded`
  read the process-wide tallies ``_build`` keeps whatever the tracer's
  state, so a zero-build guard (the serving CLI's, the recompile guard's)
  works with tracing off as well.

* **Device memory** — :func:`record_memory` snapshots the caching
  allocator (current and peak allocated bytes, reserved bytes) and the
  card's total into ``obs_device_bytes{device="cuda:i", kind, phase}``
  gauges. On the CPU path it reports the process's peak resident set under
  ``device="host"`` instead, labelled ``kind="peak_rss"`` so the two are
  never conflated.

* **Span costs** — :func:`span_costs` wraps a block inside a span and sets
  the span's kernel launches (the delta of ``kernels.LAUNCHES``, one
  ``launches_<kernel>`` attribute each) and its device milliseconds
  between two CUDA events recorded at entry and exit. Costs nest: only the
  outermost costed block waits for its end event; a costed block inside it
  (a sweep's prune, its merge) is resolved after that one wait, with the
  device counters handed to :meth:`_SpanCosts.defer`, so the host keeps
  queueing the next block behind it and a traced sweep still waits on the
  card once.

Everything here runs on the host between launches and reads only
counters, allocator statistics and events, so installing the hooks never
changes what a kernel computes.
"""
from __future__ import annotations

import resource
import sys
import threading

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T

BUILD_SECONDS_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 30.0, 60.0, 120.0,
                         300.0)

KERNEL_TRACK_TID = 2          # virtual Perfetto track for kernel builds
_install_lock = threading.Lock()
_installed = False

_BUILDS_HELP = ("nvcc runs of kernels._build.build_all (the zero-steady-"
                "state serving contract counts these)")
_LOADS_HELP = "kernel libraries opened by kernels._build.load"


def _on_build(source: str, start_s: float, dur_s: float, rc: int) -> None:
    if not T.enabled():
        return
    reg = M.REGISTRY
    reg.counter("kernel_builds_total", help=_BUILDS_HELP,
                source=source).inc()
    reg.histogram("kernel_build_seconds", buckets=BUILD_SECONDS_BUCKETS,
                  help="wall seconds per nvcc run").observe(dur_s)
    T.add_complete("kernel/build", start_s, dur_s, tid=KERNEL_TRACK_TID,
                   source=source, rc=rc)


def _on_load(entry: str, source: str) -> None:
    if not T.enabled():
        return
    M.REGISTRY.counter("kernel_libs_loaded_total", help=_LOADS_HELP,
                       source=source).inc()


def install() -> None:
    """Register the build and load listeners with ``kernels._build``
    (idempotent; the listeners are process-lifetime and gate themselves
    on ``trace.enabled()``)."""
    global _installed
    with _install_lock:
        if _installed:
            return
        _build.BUILD_LISTENERS.append(_on_build)
        _build.LOAD_LISTENERS.append(_on_load)
        _installed = True


def kernel_builds() -> int:
    """nvcc runs in this process so far (the counterpart of the
    reference's ``backend_compiles()``)."""
    return _build.TALLY["builds"]


def kernel_libs_loaded() -> int:
    """Kernel libraries opened in this process so far."""
    return _build.TALLY["loads"]


def _host_peak_rss() -> int:
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(peak if sys.platform == "darwin" else peak * 1024)   # Linux: KiB


def record_memory(phase: str = "", device: str | torch.device = "cuda") -> dict:
    """Snapshot memory into ``obs_device_bytes`` gauges and return
    ``{device: {kind: bytes}}``. ``device`` "cuda" (the current card) or
    "cuda:i" reads the caching allocator and the card's total, and raises
    without a card; "cpu" reports the process's peak RSS under "host"."""
    dev = torch.device(device)
    reg = M.REGISTRY
    help_ = "per-device memory at the last record_memory() call"
    if dev.type == "cpu":
        rss = _host_peak_rss()
        reg.gauge("obs_device_bytes", help=help_, device="host",
                  kind="peak_rss", phase=phase).set(rss)
        return {"host": {"peak_rss": rss}}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    st = torch.cuda.memory_stats(idx)
    _, total = torch.cuda.mem_get_info(idx)
    picked = {
        "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
        "peak_allocated_bytes": int(st.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
        "total_bytes": int(total),
    }
    name = f"cuda:{idx}"
    for kind, v in picked.items():
        reg.gauge("obs_device_bytes", help=help_, device=name, kind=kind,
                  phase=phase).set(v)
    return {name: picked}


_costs_tls = threading.local()     # per-thread stack of open costed blocks


def _open_costs() -> list:
    stack = getattr(_costs_tls, "stack", None)
    if stack is None:
        stack = _costs_tls.stack = []
    return stack


class _SpanCosts:
    __slots__ = ("sp", "device", "before", "ev", "values", "inner", "done")

    def __init__(self, sp, device):
        self.sp, self.device = sp, device
        self.values, self.inner, self.done = {}, [], False

    def __enter__(self):
        _open_costs().append(self)
        self.before = dict(LAUNCHES)
        self.ev = None
        if self.device is not None and self.device.type == "cuda":
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = _open_costs()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            return False
        attrs = {f"launches_{k}": v - self.before.get(k, 0)
                 for k, v in LAUNCHES.items() if v != self.before.get(k, 0)}
        attrs["launches"] = sum(attrs.values())
        self.sp.set(**attrs)
        if self.ev is not None:
            self.ev[1].record(torch.cuda.current_stream(self.device))
        if stack:                 # resolved after the outermost block's wait
            stack[0].inner.append(self)
            return False
        if self.ev is not None:
            self.ev[1].synchronize()
        for c in (self, *self.inner):
            c._resolve()
        return False

    def defer(self, **values: torch.Tensor) -> None:
        """Device scalars read into the span's attributes as Python numbers
        once the outermost costed block has waited for the card; read at
        once if this block is resolved already."""
        self.values.update(values)
        if self.done:
            self._read()

    def _resolve(self) -> None:
        if self.ev is not None:
            self.sp.set(device_ms=self.ev[0].elapsed_time(self.ev[1]))
        self.done = True
        self._read()

    def _read(self) -> None:
        self.sp.set(**{k: t.item() for k, t in self.values.items()})
        self.values.clear()


class _NoCosts:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NO_COSTS = _NoCosts()


def span_costs(sp, device: torch.device | None = None):
    """``with trace.span(...) as sp, span_costs(sp, x.device):`` — on exit
    set the block's kernel launches (``launches_<kernel>`` and their total
    ``launches``) and, on a CUDA ``device``, its ``device_ms`` between two
    events on the current stream. Inside another costed block the
    ``device_ms`` (and what :meth:`_SpanCosts.defer` was given) is set when
    the outermost one exits, after its single wait. With tracing off
    (``sp`` falsy) it does nothing at all."""
    if not sp:
        return _NO_COSTS
    return _SpanCosts(sp, None if device is None else torch.device(device))
