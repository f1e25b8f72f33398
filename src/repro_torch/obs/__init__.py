"""repro_torch.obs — span tracing and metrics (copies of ``repro.obs.trace``
and ``repro.obs.metrics``; the port imports nothing of the JAX package).

One switch (:func:`enable` / :func:`disable`, off by default) gates every
instrumented path of the port:

* ``obs.trace`` — thread-safe span tracer with Chrome/Perfetto trace-event
  JSON export and a flat summary table; no-op (single flag check, shared
  sentinel, no allocation) while disabled.
* ``obs.metrics`` — process-wide counters / gauges / explicit-bucket
  histograms with Prometheus text exposition and a JSON snapshot.

The reference's ``obs.jaxhooks`` (compile events, device-memory watermarks,
cost attributes of build spans) has no counterpart here yet, so
:func:`enable` takes no ``install_jax_hooks``. Enabling observability never
changes a result bit: instrumentation is host-side only and may only read
device values.
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace

enabled = trace.enabled
enabled_scope = trace.enabled_scope


def enable() -> None:
    """Turn on span tracing + metrics recording across the port."""
    trace.enable()


def disable() -> None:
    trace.disable()


def reset() -> None:
    """Clear recorded spans and the default metrics registry."""
    trace.reset()
    metrics.REGISTRY.reset()


__all__ = ["trace", "metrics", "enable", "disable", "enabled",
           "enabled_scope", "reset"]
