"""Batched multi-writer update path behind the single epoch swap (a copy of
``repro.serving.writer`` over the port's ``StreamingANN``).

``StreamingANN`` updates are already safe to run concurrently with readers —
each ``insert``/``delete`` builds the next store off to the side and commits
it with one Python reference swap, so a reader holding a snapshot never sees
a torn graph. What it does *not* give is a place for many independent
writers to meet: every call pays a fixed cost (a seeding search, the graft,
two frontier sweeps, each a chain of kernel launches and host syncs) that
does not shrink with the batch, so N callers each inserting one row would
pay it N times.

``BatchedWriter`` is that meeting point. Callers enqueue rows / ids from
any thread and get a :class:`WriteTicket` back; the serving pump drains the
queues in arrival order, cutting **fixed-size** batches (``insert_batch`` /
``delete_batch`` rows — the only update shapes the steady state runs) and
committing each through the underlying single epoch swap. Per-commit
overhead (launch chains, host syncs, epoch bump) divides by the batch size.

A partial tail — fewer pending rows than one batch — stays queued rather
than committing at a novel shape; ``commit(force=True)`` (shutdown /
checkpoint barrier) flushes it. Tickets resolve when their last row lands:
``ids`` carries the assigned row ids for inserts and the tombstoned-now
mask for deletes (``StreamingANN.delete``'s return), and ``wait()`` blocks
a submitting thread until its rows are queryable.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np


@dataclasses.dataclass(frozen=True)
class WriterConfig:
    insert_batch: int = 32   # rows per insert commit (one update shape)
    delete_batch: int = 32   # ids per delete commit

    def __post_init__(self):
        if self.insert_batch < 1 or self.delete_batch < 1:
            raise ValueError(
                f"insert_batch and delete_batch must be >= 1, got "
                f"({self.insert_batch}, {self.delete_batch})")


class WriteTicket:
    """Handle for one submitted write. ``ids``: per-row results, filled as
    commits land (insert: assigned row id, -1 while pending; delete: the
    pre-call liveness mask as int, -1 while pending). ``epoch``: the epoch
    of the commit that completed the ticket."""

    def __init__(self, kind: str, count: int):
        self.kind = kind
        self.ids = np.full((count,), -1, np.int64)
        self.epoch = -1
        self._remaining = count
        self._done = threading.Event()
        if count == 0:
            self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def mask(self) -> np.ndarray:
        """Delete tickets: the bool tombstoned-now mask (see
        ``StreamingANN.delete``)."""
        if self.kind != "delete":
            raise ValueError(f"mask() is for delete tickets, not {self.kind}")
        if not self.done:
            raise ValueError("ticket not committed yet — wait() first")
        return self.ids.astype(bool)

    def _land(self, pos: int, value: int, epoch: int) -> None:
        self.ids[pos] = value
        self._remaining -= 1
        if self._remaining == 0:
            self.epoch = epoch
            self._done.set()


class BatchedWriter:
    """Fan concurrent insert/delete submissions into fixed-size commits."""

    def __init__(self, ann, cfg: WriterConfig | None = None, on_commit=None):
        self.ann = ann
        self.cfg = cfg if cfg is not None else WriterConfig()
        self._on_commit = on_commit
        self._lock = threading.Lock()
        self._ins: deque[tuple[WriteTicket, int, np.ndarray]] = deque()
        self._del: deque[tuple[WriteTicket, int, int]] = deque()

    # ------------------------------------------------------------ submission
    def submit_insert(self, vectors) -> WriteTicket:
        """Queue (b, d) rows for insertion; rows from many tickets coalesce
        into one batch."""
        v = np.asarray(vectors, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        t = WriteTicket("insert", v.shape[0])
        with self._lock:
            for i in range(v.shape[0]):
                self._ins.append((t, i, v[i]))
        return t

    def submit_delete(self, ids) -> WriteTicket:
        ids_np = np.asarray(ids).reshape(-1).astype(np.int64)
        t = WriteTicket("delete", ids_np.shape[0])
        with self._lock:
            for i, rid in enumerate(ids_np):
                self._del.append((t, i, int(rid)))
        return t

    def pending(self) -> tuple[int, int]:
        with self._lock:
            return len(self._ins), len(self._del)

    # --------------------------------------------------------------- commits
    def _cut(self, q: deque, size: int, force: bool) -> list:
        """Pop one batch from ``q`` under the lock: a full ``size`` rows, or
        (force) whatever tail remains."""
        with self._lock:
            n = len(q)
            take = size if n >= size else (n if force else 0)
            return [q.popleft() for _ in range(take)]

    def commit(self, force: bool = False) -> int:
        """Drain full batches (and, with ``force``, partial tails) into the
        index. Returns the number of epoch swaps performed. Call from the
        single pump loop: commits happen on the caller's thread, serialized
        by construction."""
        from repro_torch.obs import trace as _tr
        swaps = 0
        while True:
            batch = self._cut(self._del, self.cfg.delete_batch, force)
            if not batch:
                break
            with _tr.span("serving/commit") as sp:
                ids = np.array([rid for _, _, rid in batch], np.int64)
                newly = self.ann.delete(ids)
                ep = self.ann.epoch
                if sp:
                    sp.set(kind="delete", n=len(batch), epoch=ep,
                           forced=force and len(batch) <
                           self.cfg.delete_batch)
            for (t, pos, _), live in zip(batch, newly):
                t._land(pos, int(live), ep)
            if self._on_commit is not None:
                self._on_commit("delete", len(batch), ep)
            swaps += 1
        while True:
            batch = self._cut(self._ins, self.cfg.insert_batch, force)
            if not batch:
                break
            with _tr.span("serving/commit") as sp:
                rows = np.stack([r for _, _, r in batch])
                slots = self.ann.insert(rows)
                ep = self.ann.epoch
                if sp:
                    sp.set(kind="insert", n=len(batch), epoch=ep,
                           forced=force and len(batch) <
                           self.cfg.insert_batch)
            for (t, pos, _), slot in zip(batch, slots):
                t._land(pos, int(slot), ep)
            if self._on_commit is not None:
                self._on_commit("insert", len(batch), ep)
            swaps += 1
        return swaps
