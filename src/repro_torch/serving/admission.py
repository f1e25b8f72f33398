"""Admission queue: coalesce arriving queries into fixed-shape tiles (a copy
of ``repro.serving.admission``; pure numpy).

The policy is the classic size-vs-deadline race, with both triggers derived
from the SLO instead of tuned independently:

* **Size**: a tile dispatches the moment ``tile_lanes`` requests are
  waiting — the batch is full, waiting longer buys nothing.
* **Deadline**: a partial tile dispatches once the *oldest* waiting request
  has spent ``dispatch_fraction`` of its latency budget. With the default
  fraction 1/2, a request enqueued at ``t`` with budget ``D`` is dispatched
  no later than ``t + D/2``, leaving the other ``D/2`` for the search
  itself plus result readout. Under a Poisson arrival process at rate
  ``lam`` the expected dispatch occupancy is therefore
  ``min(tile_lanes, lam * dispatch_fraction * D)`` — at low load the queue
  trades occupancy for latency (tiles go out nearly empty, nobody waits
  past half their budget), at high load tiles fill before the deadline
  trigger ever fires and throughput dominates. The crossover arrival rate
  is ``tile_lanes / (dispatch_fraction * D)``; chip_smoke.py's serving
  lines record measured occupancy next to achieved QPS so the policy's
  position on that curve is visible per session.

Dispatched tiles are always *shape* ``tile_lanes`` regardless of occupancy:
the frontend pads the query block and masks the vacant lanes with
``search_tiled(lane_valid=)``, so every tile runs the same kernels at the
same shapes whatever its occupancy, and a served request's result does not
depend on which tile carried it.

Timestamps are caller-supplied floats (seconds, any monotonic origin): the
queue never reads a wall clock itself, which is what makes the determinism
contract testable — replaying the same (arrival order, pump schedule)
against a manual clock must produce bitwise-identical per-request results
however the tile boundaries fall.

Thread safety: ``submit`` may be called from any thread; ``ready``/``take``
are meant for the single pump loop. All shared state sits behind one lock.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    tile_lanes: int = 64          # fixed dispatch width (the one tile shape)
    deadline_s: float = 0.050     # default per-request latency budget
    dispatch_fraction: float = 0.5  # dispatch when the oldest request has
    #                               spent this fraction of its budget
    max_queue: int = 1 << 16      # admission bound: submit raises past this

    def __post_init__(self):
        if self.tile_lanes < 1:
            raise ValueError(
                f"tile_lanes must be >= 1, got {self.tile_lanes}")
        if self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if not 0 < self.dispatch_fraction <= 1:
            raise ValueError(
                f"dispatch_fraction must be in (0, 1], got "
                f"{self.dispatch_fraction}")
        if self.max_queue < self.tile_lanes:
            raise ValueError(
                f"max_queue={self.max_queue} below tile_lanes="
                f"{self.tile_lanes}: the queue could never fill one tile")


@dataclasses.dataclass
class Request:
    """One admitted query. ``deadline_t`` is absolute (enqueue_t + budget)."""
    rid: int
    query: np.ndarray           # (d,) f32 host row
    enqueue_t: float
    deadline_t: float


class AdmissionQueue:
    """FIFO of admitted requests with the size-vs-deadline dispatch test."""

    def __init__(self, cfg: AdmissionConfig | None = None):
        self.cfg = cfg if cfg is not None else AdmissionConfig()
        self._lock = threading.Lock()
        self._q: deque[Request] = deque()
        self._next_rid = 0

    def submit(self, query, now: float, deadline_s: float | None = None) -> int:
        """Admit one query; returns its request id (dense, FIFO-ordered)."""
        budget = self.cfg.deadline_s if deadline_s is None else deadline_s
        if budget <= 0:
            raise ValueError(f"deadline_s must be > 0, got {budget}")
        q = np.asarray(query, np.float32).reshape(-1)
        with self._lock:
            if len(self._q) >= self.cfg.max_queue:
                raise OverflowError(
                    f"admission queue at max_queue={self.cfg.max_queue}: "
                    "the server is not keeping up with the offered load — "
                    "shed or slow the client")
            rid = self._next_rid
            self._next_rid += 1
            self._q.append(Request(rid=rid, query=q, enqueue_t=now,
                                   deadline_t=now + budget))
        return rid

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def ready(self, now: float) -> bool:
        """True when a tile should dispatch: full, or the oldest request has
        spent ``dispatch_fraction`` of its budget."""
        with self._lock:
            if not self._q:
                return False
            if len(self._q) >= self.cfg.tile_lanes:
                return True
            head = self._q[0]
            trigger = head.enqueue_t + self.cfg.dispatch_fraction * (
                head.deadline_t - head.enqueue_t)
            return now >= trigger

    def next_trigger(self) -> float | None:
        """The absolute time at which ``ready`` flips true by deadline alone
        (None when empty). Lets a pump loop sleep instead of spin."""
        with self._lock:
            if not self._q:
                return None
            head = self._q[0]
            return head.enqueue_t + self.cfg.dispatch_fraction * (
                head.deadline_t - head.enqueue_t)

    def take(self) -> list[Request]:
        """Pop up to ``tile_lanes`` requests in FIFO order (the caller is
        expected to have consulted ``ready``; draining a partial tail at
        shutdown calls this directly)."""
        with self._lock:
            k = min(len(self._q), self.cfg.tile_lanes)
            return [self._q.popleft() for _ in range(k)]
