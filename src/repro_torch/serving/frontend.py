"""The serving event loop: admission → staging → fixed-shape dispatch →
harvest, with the writer path committing between tiles (port of
``repro.serving.frontend``, single device).

One ``pump()`` turn does, in order: commit any full write batches
(:class:`repro_torch.serving.writer.BatchedWriter`), dispatch admission
tiles while the size-vs-deadline policy says go, and harvest in-flight tiles
past ``pipeline_depth``. Everything is driven by a caller-supplied monotonic
clock, so tests replay sessions against a manual clock and get bitwise
reproducibility.

Epoch consistency: ``_dispatch`` captures ``ann.snapshot()`` **once** and
the whole tile — entry-point seeding, validity mask, beam search — runs
against that store, even if the writer commits ten epochs while the tile is
in flight. The telemetry's per-tile staleness (epoch at completion minus
epoch at dispatch) measures exactly how often that protection mattered.

Shape discipline (every tile runs the same kernels at the same shapes, so a
session builds no kernel after warm-up):

* queries: always ``(tile_lanes, d)`` via the staging buffer, vacant lanes
  zeroed and masked with ``lane_valid`` — occupancy never changes shape;
* entry points: one scalar per epoch, cached (recomputing per tile would
  cost launches for nothing);
* store: capacity is power-of-two padded, so only growth events (O(log n))
  change any operand shape;
* writes: fixed ``insert_batch``/``delete_batch`` commits.

The port's search reads its ``go`` flag on the host every few iterations
(``repro_torch.core.search``), so ``_dispatch`` returns only when most of
the tile has run: ``pipeline_depth`` overlaps the tile's tail and readout,
not its search.

Results are buffered per request id until ``result()`` collects them —
the transport layer of a real server (RPC futures) is out of scope; what is
in scope is that a request's (ids, dists) are bitwise independent of which
tile and lane served it (with ``visited="dense"``: hashed inserts that race
for one slot pick a winner that varies on CUDA).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import search as S
from repro_torch.obs import trace as _tr
from repro_torch.serving.admission import AdmissionConfig, AdmissionQueue, Request
from repro_torch.serving.staging import DoubleBuffer
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.writer import BatchedWriter, WriterConfig, WriteTicket
from repro_torch.streaming import store as ST


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    admission: AdmissionConfig = AdmissionConfig()
    writer: WriterConfig = WriterConfig()
    search: S.SearchConfig = S.SearchConfig(topk=10)
    shard: str = "queries"       # serve layout: "queries" | "corpus"
    pipeline_depth: int = 2      # in-flight tiles before a blocking harvest
    record_work: bool = False    # thread with_stats through the search

    def __post_init__(self):
        if self.shard not in ("queries", "corpus"):
            raise ValueError(
                f"unknown shard mode {self.shard!r}: expected \"queries\" "
                "or \"corpus\"")
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}")


@dataclasses.dataclass
class _Inflight:
    reqs: list[Request]
    ids: torch.Tensor
    dists: torch.Tensor
    work: int | None
    dispatch_t: float
    epoch: int
    tile_index: int


class ServingFrontend:
    """Single-pump serving loop over a :class:`StreamingANN`."""

    def __init__(self, ann, cfg: ServingConfig | None = None,
                 clock=time.perf_counter):
        self.ann = ann
        self.cfg = cfg if cfg is not None else ServingConfig()
        if self.cfg.shard == "corpus":
            raise ValueError(
                "ServingConfig(shard=\"corpus\") needs a mesh-bound index: "
                "corpus sharding partitions rows over a mesh, and this "
                "StreamingANN is single-device")
        if self.cfg.search.quant.is_coded and ann.store.qx is None:
            raise ValueError(
                f"serving config requests quant mode "
                f"{self.cfg.search.quant.mode!r} but the store holds no "
                "codes — quantize the index first")
        self.clock = clock
        self.queue = AdmissionQueue(self.cfg.admission)
        self.telemetry = Telemetry()
        self.writer = BatchedWriter(ann, self.cfg.writer,
                                    on_commit=self.telemetry.record_commit)
        self.staging = DoubleBuffer(self.cfg.admission.tile_lanes,
                                    ann.store.dim, device=ann.store.x.device)
        self._results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._inflight: deque[_Inflight] = deque()
        self._ep_cache: tuple[int, torch.Tensor] | None = None

    # --------------------------------------------------------------- ingress
    def submit(self, query, deadline_s: float | None = None) -> int:
        """Admit one query; returns its request id."""
        now = self.clock()
        rid = self.queue.submit(query, now, deadline_s=deadline_s)
        budget = self.cfg.admission.deadline_s if deadline_s is None \
            else deadline_s
        self.telemetry.record_enqueue(rid, now, now + budget)
        return rid

    def submit_insert(self, vectors) -> WriteTicket:
        return self.writer.submit_insert(vectors)

    def submit_delete(self, ids) -> WriteTicket:
        return self.writer.submit_delete(ids)

    # ------------------------------------------------------------- the pump
    def pump(self, now: float | None = None) -> bool:
        """One loop turn; returns True if any work was done."""
        now = self.clock() if now is None else now
        did = self.writer.commit() > 0
        while self.queue.ready(now):
            self._dispatch(now)
            did = True
        while len(self._inflight) > self.cfg.pipeline_depth - 1:
            # keep at most depth-1 tiles pending after the pump returns, so
            # the *next* dispatch's staging overlaps the oldest one's tail
            self._harvest()
            did = True
        return did

    def drain(self, flush_writes: bool = True) -> None:
        """Dispatch every waiting request (partial tail included), harvest
        all in-flight tiles, and optionally force-flush partial write
        batches (a one-off update shape — shutdown only)."""
        while self.queue.depth() > 0:
            self._dispatch(self.clock())
        while self._inflight:
            self._harvest()
        self.writer.commit(force=flush_writes)

    def busy(self) -> bool:
        return self.queue.depth() > 0 or len(self._inflight) > 0

    # --------------------------------------------------------------- egress
    def result(self, rid: int) -> tuple[np.ndarray, np.ndarray]:
        """(ids, dists) for a completed request (popped — each result is
        collected once). Raises KeyError while the request is queued or in
        flight: poll ``pump`` / ``drain`` first."""
        return self._results.pop(rid)

    # ------------------------------------------------------------- internals
    def _entry(self, st: ST.Store, epoch: int) -> torch.Tensor:
        if self._ep_cache is None or self._ep_cache[0] != epoch:
            eps = S.default_entry_point(st.x, self.cfg.search.metric,
                                        valid=ST.active_mask(st))
            self._ep_cache = (epoch, eps)
        return self._ep_cache[1]

    def _dispatch(self, now: float) -> None:
        depth_before = self.queue.depth()
        reqs = self.queue.take()
        if not reqs:
            return
        with _tr.span("serving/dispatch") as dsp:
            epoch, st = self.ann.snapshot()
            eps = self._entry(st, epoch)
            with _tr.span("serving/stage"):
                q_dev = self.staging.stage([r.query for r in reqs])
                lv = self.staging.lane_mask(len(reqs))
            with _tr.span("serving/search_dispatch"):
                # the search returns with its last iterations still queued
                # on the device; their end is observed at serving/readout
                out = self.ann.search(
                    q_dev, self.cfg.search, entry_points=eps,
                    tile_b=self.cfg.admission.tile_lanes,
                    with_stats=self.cfg.record_work, lane_valid=lv, store=st)
            if self.cfg.record_work:
                ids, dists, stats = out
                work = stats["work"]
            else:
                ids, dists = out
                work = None
            tile_index = self.telemetry.tiles_dispatched
            if dsp:
                dsp.set(occupancy=len(reqs),
                        tile_lanes=self.cfg.admission.tile_lanes,
                        queue_depth=depth_before - len(reqs), epoch=epoch,
                        tile_index=tile_index,
                        oldest_wait_s=now - min(r.enqueue_t for r in reqs))
            self.telemetry.record_dispatch(
                [r.rid for r in reqs], now, occupancy=len(reqs),
                tile_lanes=self.cfg.admission.tile_lanes,
                queue_depth=depth_before - len(reqs), epoch=epoch)
            self._inflight.append(_Inflight(
                reqs=reqs, ids=ids, dists=dists, work=work, dispatch_t=now,
                epoch=epoch, tile_index=tile_index))

    def _harvest(self) -> None:
        t = self._inflight.popleft()
        with _tr.span("serving/readout") as sp:
            ids = t.ids.cpu().numpy()      # blocks until the tile finishes
            dists = t.dists.cpu().numpy()
            if sp:
                sp.set(occupancy=len(t.reqs), tile_index=t.tile_index,
                       epoch_dispatch=t.epoch)
        done_t = self.clock()
        self.telemetry.record_complete(
            [r.rid for r in t.reqs], done_t, tile_index=t.tile_index,
            epoch=self.ann.epoch, work=t.work)
        for lane, r in enumerate(t.reqs):
            self._results[r.rid] = (ids[lane], dists[lane])
