"""repro_torch.obs — span tracing and metrics (copies of ``repro.obs.trace``
and ``repro.obs.metrics``; the port imports nothing of the JAX package).

One switch (:func:`enable` / :func:`disable`, off by default) gates every
instrumented path of the port:

* ``obs.trace`` — thread-safe span tracer with Chrome/Perfetto trace-event
  JSON export and a flat summary table; no-op (single flag check, shared
  sentinel, no allocation) while disabled.
* ``obs.metrics`` — process-wide counters / gauges / explicit-bucket
  histograms with Prometheus text exposition and a JSON snapshot.
* ``obs.cudahooks`` — the counterpart of the reference's ``obs.jaxhooks``:
  kernel builds and library loads (the port's compiles), allocator
  watermarks, and the launches and device time of a span.
* ``obs.graphstats`` — the per-sweep graph readouts of the build spans.

Instrumented paths: every sweep and reverse pass of the three index builds
(``rnn_descent/*``, ``nn_descent/iter``, ``nsg_style/*``, on every rank of
a mesh), ``search/tiled``, ``eval/timed``, the serving front end
(``serving/*``, ``request/*``) and the kernel builds (``kernel/*``).

Enabling observability never changes a result bit: instrumentation is
host-side only (a traced span adds a device synchronisation and small
reductions read to the host, never a different launch) and may only read
device values. ``python -m repro_torch.obs`` runs a scripted build +
search + serve session, checks that contract, and writes ``trace.json``
and ``metrics.prom``.
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace

enabled = trace.enabled
enabled_scope = trace.enabled_scope


def enable(install_hooks: bool = True) -> None:
    """Turn on span tracing + metrics recording across the port; by
    default also install the kernel-build listeners (idempotent)."""
    if install_hooks:
        from repro_torch.obs import cudahooks
        cudahooks.install()
    trace.enable()


def disable() -> None:
    trace.disable()


def reset() -> None:
    """Clear recorded spans and the default metrics registry."""
    trace.reset()
    metrics.REGISTRY.reset()


__all__ = ["trace", "metrics", "enable", "disable", "enabled",
           "enabled_scope", "reset"]
