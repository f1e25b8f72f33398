"""Process-wide metrics registry: counters, gauges, histograms with
explicit buckets, Prometheus text exposition and a JSON snapshot (a copy of
``repro.obs.metrics``: the port imports nothing of the JAX package).

Pure host-side Python (no torch import): recording a metric can never
launch a kernel or touch a device, so instrumentation composes with the
bitwise-parity contracts. Thread-safe — one lock per
registry, matching the serving telemetry's locking discipline.

Naming follows Prometheus conventions (``snake_case``, ``_total`` suffix on
counters, base-unit suffixes like ``_seconds``); labels are plain
``str -> str`` pairs. A metric family is (name, type, help); children are
one per label set::

    REGISTRY.counter("serving_requests_total", help="admitted").inc()
    REGISTRY.histogram("tile_occupancy", buckets=(0.25, 0.5, 0.75, 1.0))\\
            .observe(0.8)
    print(REGISTRY.exposition())      # Prometheus text format
    REGISTRY.snapshot()               # JSON-friendly dict

The module-level :data:`REGISTRY` is the process default every instrumented
path records into; tests construct private :class:`Registry` instances.
Instrumentation sites gate on ``trace.enabled()`` (the single obs switch),
so the default registry is never mutated while observability is off — the
disabled-mode no-op contract in tests/test_obs.py.
"""
from __future__ import annotations

import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_SECONDS_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up: inc({v})")
        with self._lock:
            self.value += v


class Gauge:
    """Last-write-wins value (plus inc/dec for level tracking)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self.value -= v


class Histogram:
    """Explicit-bucket histogram: ``counts[i]`` observations ``<=
    buckets[i]`` (non-cumulative internally; exposition emits the
    Prometheus cumulative ``_bucket{le=...}`` form plus the implicit
    ``+Inf``), with ``sum`` and ``count``."""

    __slots__ = ("_lock", "buckets", "counts", "inf_count", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets: tuple[float, ...]):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.inf_count = 0
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.counts[i] += 1
                    return
            self.inf_count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+inf, count)."""
        with self._lock:
            out, acc = [], 0
            for le, c in zip(self.buckets, self.counts):
                acc += c
                out.append((le, acc))
            out.append((float("inf"), acc + self.inf_count))
            return out


class _Family:
    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name: str, kind: str, help: str,
                 buckets: tuple[float, ...] | None):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: dict[tuple[tuple[str, str], ...], object] = {}


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Registry:
    """A namespace of metric families. ``counter``/``gauge``/``histogram``
    create-or-return the child for the given labels (idempotent, so call
    sites never pre-declare); re-declaring a name with a different type or
    bucket layout raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # ------------------------------------------------------------- creation
    def _family(self, name: str, kind: str, help: str,
                buckets: tuple[float, ...] | None = None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help, buckets)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            elif kind == "histogram" and buckets is not None \
                    and fam.buckets != buckets:
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{fam.buckets}, requested {buckets}")
            if help and not fam.help:
                fam.help = help
            return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        fam = self._family(name, "counter", help)
        return self._child(fam, labels, lambda: Counter(self._lock))

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        fam = self._family(name, "gauge", help)
        return self._child(fam, labels, lambda: Gauge(self._lock))

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = DEFAULT_SECONDS_BUCKETS,
                  help: str = "", **labels) -> Histogram:
        buckets = tuple(float(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"histogram buckets must be strictly increasing and "
                f"non-empty, got {buckets}")
        fam = self._family(name, "histogram", help, buckets)
        return self._child(fam, labels,
                           lambda: Histogram(self._lock, fam.buckets))

    def _child(self, fam: _Family, labels: dict, make):
        key = _label_key(labels)
        with self._lock:
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = make()
            return child

    # -------------------------------------------------------------- readout
    def __len__(self) -> int:
        with self._lock:
            return len(self._families)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    def snapshot(self) -> dict:
        """JSON-friendly dump: {name: {type, help, samples: [...]}}."""
        with self._lock:
            fams = list(self._families.values())
        out = {}
        for fam in fams:
            samples = []
            for key, child in fam.children.items():
                labels = dict(key)
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "buckets": {_fmt(le): c
                                    for le, c in child.cumulative()},
                        "sum": child.sum,
                        "count": child.count,
                    })
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            fams = list(self._families.values())
        lines: list[str] = []
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children.items():
                base = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in key)
                if fam.kind == "histogram":
                    for le, c in child.cumulative():
                        lab = (base + "," if base else "") + f'le="{_fmt(le)}"'
                        lines.append(f"{fam.name}_bucket{{{lab}}} {c}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}_sum{suffix} {_fmt(child.sum)}")
                    lines.append(
                        f"{fam.name}_count{suffix} {child.count}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = Registry()


def write_exposition(path: str, registry: Registry | None = None) -> None:
    with open(path, "w") as f:
        f.write((registry or REGISTRY).exposition())
