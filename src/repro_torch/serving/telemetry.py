"""SLO telemetry: per-request lifecycle timestamps folded into the numbers
an operator actually pages on (a copy of ``repro.serving.telemetry`` on the
port's ``obs``: the same metric names, buckets and ``summary()`` keys).

Every request is stamped three times — **enqueue** (admission), **dispatch**
(its tile launched), **complete** (its tile's results were materialized on
the host) — and every tile records its occupancy, the queue depth it left
behind, and the store epoch at dispatch vs completion. ``summary()`` folds
those into:

* latency percentiles (p50/p95/p99, ms) of complete - enqueue, the
  user-visible number; plus the dispatch-wait component (dispatch -
  enqueue) so "queueing" and "compute" regressions are distinguishable,
* achieved QPS = completed requests / (last completion - first enqueue),
* deadline hit rate (completions within each request's admitted budget),
* batch-occupancy histogram (how full tiles ran — the admission policy's
  operating point) and queue-depth histogram (backlog distribution),
* epoch staleness per tile (epoch at completion minus epoch at dispatch:
  how many write commits landed while the tile was in flight — the
  concurrency the epoch-snapshot design absorbs),
* write-commit counts per kind.

A session that completed zero requests has **no latency samples**: every
rate/percentile in ``summary()`` is then ``None`` (never a fabricated
0.0), so downstream consumers must skip — not record — such sessions.

Observability: the recorder doubles as the serving layer's bridge into
``repro_torch.obs`` — while obs is enabled (or an explicit ``registry`` is
passed) every stamp also lands in the process metrics registry
(``serving_*`` counters/histograms; ``summary()`` publishes the percentile
gauges), and each completion back-fills ``serving/request`` lifecycle
spans (queue-wait + service segments, on virtual request tracks) from its
stored timestamps. With obs disabled and no explicit registry this class
touches neither — the disabled-mode no-op contract (tests/test_obs.py on
the reference, tests/test_torch_serving.py here).

Pure numpy over plain floats — no torch, so recording never launches a
kernel or waits on the device.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T

_PCTS = (50.0, 95.0, 99.0)

LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5)
DEPTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0)
_REQUEST_TRACKS = 64       # virtual Perfetto tracks for request spans


def _pct(a: np.ndarray, q: float) -> float | None:
    return float(np.percentile(a, q)) if a.size else None


class Telemetry:
    """Append-only recorder; ``summary()`` is the only reader.

    ``registry``: an explicit :class:`repro_torch.obs.metrics.Registry` to mirror
    stamps into unconditionally; ``None`` (default) mirrors into the
    process registry only while ``repro_torch.obs`` is enabled."""

    def __init__(self, registry: M.Registry | None = None):
        self._lock = threading.Lock()
        self._registry = registry
        self._enq: dict[int, float] = {}
        self._deadline: dict[int, float] = {}
        self._disp: dict[int, float] = {}
        self._comp: dict[int, float] = {}
        self._tiles: list[dict] = []
        self._commits: list[dict] = []

    def _reg(self) -> M.Registry | None:
        if self._registry is not None:
            return self._registry
        return M.REGISTRY if T.enabled() else None

    # ------------------------------------------------------------- recording
    def record_enqueue(self, rid: int, t: float, deadline_t: float) -> None:
        with self._lock:
            self._enq[rid] = t
            self._deadline[rid] = deadline_t
        reg = self._reg()
        if reg is not None:
            reg.counter("serving_requests_total",
                        help="requests admitted").inc()

    def record_dispatch(self, rids: list[int], t: float, *, occupancy: int,
                        tile_lanes: int, queue_depth: int,
                        epoch: int) -> None:
        with self._lock:
            for r in rids:
                self._disp[r] = t
            self._tiles.append({
                "t": t, "occupancy": occupancy, "tile_lanes": tile_lanes,
                "queue_depth": queue_depth, "epoch_dispatch": epoch,
                "epoch_complete": None, "work": None,
            })
        reg = self._reg()
        if reg is not None:
            reg.counter("serving_tiles_dispatched_total",
                        help="admission tiles launched").inc()
            reg.histogram("serving_tile_occupancy",
                          buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                                   0.875, 1.0),
                          help="occupied lanes / tile_lanes per dispatched "
                               "tile").observe(occupancy / tile_lanes)
            reg.histogram("serving_queue_depth", buckets=DEPTH_BUCKETS,
                          help="admission backlog left behind per "
                               "dispatch").observe(queue_depth)

    def record_complete(self, rids: list[int], t: float, *, tile_index: int,
                        epoch: int, work: int | None = None) -> None:
        with self._lock:
            for r in rids:
                self._comp[r] = t
            tile = self._tiles[tile_index]
            tile["epoch_complete"] = epoch
            tile["work"] = work
            staleness = epoch - tile["epoch_dispatch"]
            stamps = [(r, self._enq.get(r), self._disp.get(r))
                      for r in rids]
        reg = self._reg()
        if reg is not None:
            reg.counter("serving_requests_completed_total",
                        help="requests whose results reached the "
                             "host").inc(len(rids))
            reg.histogram("serving_epoch_staleness",
                          buckets=STALENESS_BUCKETS,
                          help="write epochs landed while the tile was in "
                               "flight").observe(staleness)
            lat_h = reg.histogram("serving_request_latency_seconds",
                                  buckets=LATENCY_BUCKETS,
                                  help="enqueue -> host-side completion")
            wait_h = reg.histogram("serving_dispatch_wait_seconds",
                                   buckets=LATENCY_BUCKETS,
                                   help="enqueue -> tile dispatch")
            for _, enq, disp in stamps:
                if enq is not None:
                    lat_h.observe(t - enq)
                if enq is not None and disp is not None:
                    wait_h.observe(disp - enq)
        if T.enabled():
            # back-fill per-request lifecycle spans from the stored stamps
            # (same perf_counter domain as the tracer when the frontend
            # runs on the default clock; manual-clock tests leave obs off)
            for rid, enq, disp in stamps:
                if enq is None:
                    continue
                track = 1000 + rid % _REQUEST_TRACKS
                T.add_complete("serving/request", enq, t - enq, tid=track,
                               rid=rid, tile_index=tile_index,
                               staleness=staleness)
                if disp is not None:
                    T.add_complete("request/queue_wait", enq, disp - enq,
                                   tid=track, depth=1, rid=rid)
                    T.add_complete("request/service", disp, t - disp,
                                   tid=track, depth=1, rid=rid)

    def record_commit(self, kind: str, n: int, epoch: int) -> None:
        with self._lock:
            self._commits.append({"kind": kind, "n": n, "epoch": epoch})
        reg = self._reg()
        if reg is not None:
            reg.counter("serving_write_commits_total",
                        help="writer batch commits", kind=kind).inc()
            reg.counter("serving_rows_written_total",
                        help="rows landed through the writer",
                        kind=kind).inc(n)

    @property
    def tiles_dispatched(self) -> int:
        with self._lock:
            return len(self._tiles)

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        with self._lock:
            done = sorted(r for r in self._comp if r in self._enq)
            enq = np.array([self._enq[r] for r in done])
            disp = np.array([self._disp[r] for r in done])
            comp = np.array([self._comp[r] for r in done])
            dl = np.array([self._deadline[r] for r in done])
            tiles = [dict(t) for t in self._tiles]
            commits = list(self._commits)

        lat = (comp - enq) * 1e3                      # ms, user-visible
        wait = (disp - enq) * 1e3                     # ms, queueing component
        span = float(comp.max() - enq.min()) if done else 0.0
        occ = np.array([t["occupancy"] / t["tile_lanes"] for t in tiles]) \
            if tiles else np.zeros((0,))
        depth = np.array([t["queue_depth"] for t in tiles], np.int64) \
            if tiles else np.zeros((0,), np.int64)
        stale = np.array([t["epoch_complete"] - t["epoch_dispatch"]
                          for t in tiles
                          if t["epoch_complete"] is not None], np.int64)
        occ_hist, occ_edges = np.histogram(occ, bins=8, range=(0.0, 1.0))
        if depth.size:
            dmax = max(int(depth.max()), 1)
            d_edges = [0] + [2 ** i for i in range(dmax.bit_length() + 1)]
            d_hist, _ = np.histogram(depth, bins=d_edges)
        else:
            d_edges, d_hist = [0, 1], np.zeros((1,), np.int64)
        out = {
            "completed": len(done),
            "achieved_qps": (len(done) / span) if span > 0 else None,
            "latency_ms": {f"p{int(q)}": _pct(lat, q) for q in _PCTS},
            "dispatch_wait_ms": {f"p{int(q)}": _pct(wait, q) for q in _PCTS},
            "deadline_hit_rate": float(np.mean(comp <= dl)) if done else None,
            "tiles": len(tiles),
            "occupancy_mean": float(occ.mean()) if occ.size else None,
            "occupancy_hist": {
                "edges": [round(float(e), 4) for e in occ_edges],
                "counts": occ_hist.astype(int).tolist(),
            },
            "queue_depth_p95": _pct(depth.astype(np.float64), 95.0),
            "queue_depth_hist": {
                "edges": [int(e) for e in d_edges],
                "counts": d_hist.astype(int).tolist(),
            },
            "staleness_mean": float(stale.mean()) if stale.size else None,
            "staleness_max": int(stale.max()) if stale.size else 0,
            "write_commits": {
                k: sum(1 for c in commits if c["kind"] == k)
                for k in ("insert", "delete")
            },
            "rows_written": {
                k: sum(c["n"] for c in commits if c["kind"] == k)
                for k in ("insert", "delete")
            },
        }
        self._publish(out)
        return out

    def _publish(self, summ: dict) -> None:
        """Mirror the folded SLO stats into the metrics registry as gauges
        (the Prometheus-side view of ``summary()``)."""
        reg = self._reg()
        if reg is None:
            return
        for q, v in summ["latency_ms"].items():
            if v is not None:
                reg.gauge("serving_latency_ms",
                          help="end-to-end latency percentile at the last "
                               "summary()", quantile=q).set(v)
        for q, v in summ["dispatch_wait_ms"].items():
            if v is not None:
                reg.gauge("serving_dispatch_wait_ms",
                          help="dispatch-wait percentile at the last "
                               "summary()", quantile=q).set(v)
        scalars = {
            "serving_achieved_qps": summ["achieved_qps"],
            "serving_deadline_hit_rate": summ["deadline_hit_rate"],
            "serving_occupancy_mean": summ["occupancy_mean"],
            "serving_queue_depth_p95": summ["queue_depth_p95"],
            "serving_staleness_mean": summ["staleness_mean"],
        }
        for name, v in scalars.items():
            if v is not None:
                reg.gauge(name, help="serving summary() gauge").set(v)
