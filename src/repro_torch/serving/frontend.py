"""The serving event loop: admission → staging → fixed-shape dispatch →
harvest, with the writer path committing between tiles (port of
``repro.serving.frontend``).

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

A mesh-bound index (``StreamingANN(mesh=)``, SPMD ranks): every rank must
enter each collective search and each commit in the same order, and a clock
read on each rank would split their dispatch decisions. So rank 0 (the
leader) owns the admission queue, the clock and the writer's batching, and
announces each step to the other ranks through the comm layer before it
runs it: a tile (its staged queries, live-lane count and pinned epoch), a
write batch, or the end of the session (:meth:`ServingFrontend.close`).
The other ranks run :meth:`ServingFrontend.follow`, which applies the same
steps, and read no result: results are collected on rank 0. Under
``shard="queries"`` each tile's lanes split over the ranks; under
``"corpus"`` each beam step goes through the corpus-sharded collectives.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import search as S
from repro_torch.distributed import comm as C
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


# the steps rank 0 announces to the other ranks of a mesh (header word 0)
_STOP, _TILE, _INSERT, _DELETE = range(4)


class _Announced:
    """The index as rank 0's writer sees it under a mesh: each commit is
    announced to the other ranks before it runs (every rank's update is a
    collective)."""

    def __init__(self, fe: "ServingFrontend"):
        self._fe = fe

    @property
    def epoch(self) -> int:
        return self._fe.ann.epoch

    def insert(self, rows):
        rows = np.asarray(rows, np.float32)
        self._fe._announce(_INSERT, rows.shape[0], payload=torch.from_numpy(rows))
        return self._fe.ann.insert(rows)

    def delete(self, ids):
        ids = np.asarray(ids, np.int64)
        self._fe._announce(_DELETE, ids.shape[0], payload=torch.from_numpy(ids))
        return self._fe.ann.delete(ids)


class ServingFrontend:
    """Single-pump serving loop over a :class:`StreamingANN` (on rank 0 of a
    mesh-bound index; the other ranks :meth:`follow`)."""

    def __init__(self, ann, cfg: ServingConfig | None = None,
                 clock=time.perf_counter):
        self.ann = ann
        self.cfg = cfg if cfg is not None else ServingConfig()
        self.mesh = ann.mesh
        if self.cfg.shard == "corpus" and self.mesh is None:
            raise ValueError(
                "ServingConfig(shard=\"corpus\") needs a mesh-bound index: "
                "corpus sharding partitions rows over the mesh")
        if self.cfg.search.quant.is_coded and ann.store.qx is None:
            raise ValueError(
                f"serving config requests quant mode "
                f"{self.cfg.search.quant.mode!r} but the store holds no "
                "codes — quantize the index first")
        self.clock = clock
        self.queue = AdmissionQueue(self.cfg.admission)
        self.telemetry = Telemetry()
        self.leader = self.mesh is None or self.mesh.rank == 0
        self.writer = BatchedWriter(ann if self.mesh is None else _Announced(self),
                                    self.cfg.writer, on_commit=self.telemetry.record_commit)
        self.staging = DoubleBuffer(self.cfg.admission.tile_lanes,
                                    ann.store.dim, device=ann.store.x.device)
        self._results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._inflight: deque[_Inflight] = deque()
        self._ep_cache: tuple[int, torch.Tensor] | None = None

    # --------------------------------------------------------------- ingress
    def submit(self, query, deadline_s: float | None = None) -> int:
        """Admit one query; returns its request id."""
        self._check_leader()
        now = self.clock()
        rid = self.queue.submit(query, now, deadline_s=deadline_s)
        budget = self.cfg.admission.deadline_s if deadline_s is None \
            else deadline_s
        self.telemetry.record_enqueue(rid, now, now + budget)
        return rid

    def submit_insert(self, vectors) -> WriteTicket:
        self._check_leader()
        return self.writer.submit_insert(vectors)

    def submit_delete(self, ids) -> WriteTicket:
        self._check_leader()
        return self.writer.submit_delete(ids)

    # ------------------------------------------------------------- the pump
    def pump(self, now: float | None = None) -> bool:
        """One loop turn; returns True if any work was done."""
        self._check_leader()
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
        self._check_leader()
        while self.queue.depth() > 0:
            self._dispatch(self.clock())
        while self._inflight:
            self._harvest()
        self.writer.commit(force=flush_writes)

    def busy(self) -> bool:
        return self.queue.depth() > 0 or len(self._inflight) > 0

    # ------------------------------------------------------------ the mesh
    def close(self) -> None:
        """End the session on every rank: rank 0 of a mesh-bound index
        tells the followers to return from :meth:`follow` (without a mesh,
        nothing to do). Call it after :meth:`drain`."""
        self._check_leader()
        if self.mesh is not None:
            self._announce(_STOP, 0)

    def follow(self) -> int:
        """Rank r > 0 of a mesh-bound index: apply rank 0's steps in its
        order (each tile searched on the epoch rank 0 pinned, each write
        batch committed) until rank 0 calls :meth:`close`. Returns the
        number of steps applied. Results stay on rank 0."""
        if self.leader:
            raise RuntimeError("follow() runs on the ranks other than rank 0 of a mesh")
        dev, lanes, d = self.ann.store.x.device, self.cfg.admission.tile_lanes, self.ann.store.dim
        steps = 0
        while True:
            op, n, epoch = self._announce().tolist()      # rank 0's header
            if op == _STOP:
                return steps
            if op == _TILE:
                q = self._payload(torch.empty((lanes, d), device=dev))
                ep, st = self.ann.snapshot()
                if ep != epoch:
                    raise RuntimeError(f"rank {self.mesh.rank} holds epoch {ep}, rank 0 "
                                       f"dispatched its tile on epoch {epoch}")
                self._search(q, torch.arange(lanes, device=dev) < n, st, ep)
            elif op == _INSERT:
                self.ann.insert(self._payload(torch.empty((n, d), device=dev)))
            elif op == _DELETE:
                self.ann.delete(self._payload(torch.empty((n,), dtype=torch.int64, device=dev)))
            else:
                raise RuntimeError(f"unknown step {op} from rank 0")
            steps += 1

    def _check_leader(self) -> None:
        if not self.leader:
            raise RuntimeError(
                f"rank {self.mesh.rank} of the mesh follows rank 0's session: call follow()")

    def _announce(self, op: int = _STOP, n: int = 0, epoch: int = -1,
                  payload=None) -> torch.Tensor:
        """Broadcast from rank 0 the header (op, n, epoch) of a step, and on
        rank 0 its payload; returns rank 0's header (the other ranks' own
        arguments are placeholders; they receive the payload through
        :meth:`_payload`)."""
        head = torch.tensor([op, n, epoch], dtype=torch.int64, device=self.mesh.device)
        head = C.broadcast(head, self.mesh, self.mesh.axis_names)
        if payload is not None:
            self._payload(payload.to(self.mesh.device))
        return head

    def _payload(self, t: torch.Tensor) -> torch.Tensor:
        return C.broadcast(t.contiguous(), self.mesh, self.mesh.axis_names)

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
            with _tr.span("serving/stage"):
                q_dev = self.staging.stage([r.query for r in reqs])
                lv = self.staging.lane_mask(len(reqs))
            if self.mesh is not None:
                self._announce(_TILE, len(reqs), epoch, payload=q_dev)
            with _tr.span("serving/search_dispatch"):
                # the search returns with its last iterations still queued
                # on the device; their end is observed at serving/readout
                out = self._search(q_dev, lv, st, epoch)
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

    def _search(self, q_dev, lv, st: ST.Store, epoch: int):
        return self.ann.search(
            q_dev, self.cfg.search, entry_points=self._entry(st, epoch),
            tile_b=self.cfg.admission.tile_lanes, shard=self.cfg.shard,
            with_stats=self.cfg.record_work, lane_valid=lv, store=st)

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
