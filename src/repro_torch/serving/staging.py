"""Ring-buffered host→device query staging (port of
``repro.serving.staging``, rewritten for CUDA's asynchronous copies).

Each dispatched tile needs its admitted queries packed from the per-request
host rows into one dense (tile_lanes, d) f32 block and shipped to the
device. Two details matter for the serving loop:

* **Reused buffers, constant shape.** The pack target cycles through
  ``depth`` preallocated host buffers instead of allocating per tile — the
  block shape never varies (vacant lanes are zero-filled and masked
  downstream by ``lane_valid``), so the transfer is the same size every
  time and every tile runs the same kernels at the same shapes.

* **Overlap without a race.** On a CUDA device the buffers are pinned and
  the copy is issued with ``non_blocking=True``: it is queued on the current
  stream and may run long after :meth:`DoubleBuffer.stage` returns. The
  reference can rewrite a buffer two tiles later because its
  ``jnp.asarray`` copies at once; here a pump turn that dispatches several
  tiles before any harvest would rewrite buffer A while A's copy still
  waits in the queue. So each copy records a CUDA event, and ``stage``
  waits on the event of the buffer it is about to rewrite — a wait that
  only blocks when the ring has wrapped onto a copy the device has not
  reached yet.

On a CPU device the block is a plain copy of the buffer: a CPU tensor must
never alias a buffer the next ``stage`` rewrites.
"""
from __future__ import annotations

import numpy as np
import torch


class DoubleBuffer:
    """Ring of ``depth`` reusable (tile_lanes, d) host staging buffers."""

    def __init__(self, tile_lanes: int, d: int, depth: int = 2,
                 device: str | torch.device = "cuda"):
        if tile_lanes < 1 or d < 1:
            raise ValueError(
                f"tile_lanes and d must be >= 1, got ({tile_lanes}, {d})")
        if depth < 2:
            raise ValueError(
                f"depth must be >= 2 (one buffer would be rewritten while "
                f"its transfer is still in flight), got {depth}")
        self.tile_lanes = tile_lanes
        self.d = d
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._bufs = [torch.zeros((tile_lanes, d), dtype=torch.float32, pin_memory=pin)
                      for _ in range(depth)]
        self._events: list = [None] * depth     # the last copy out of each buffer
        self._turn = 0

    def stage(self, rows: list[np.ndarray]) -> torch.Tensor:
        """Pack up to ``tile_lanes`` host rows into the next buffer and issue
        the device transfer. Vacant lanes are zeroed (their results are
        discarded via ``lane_valid`` masking, but a stale query from a prior
        tile must never alias into a fresh one)."""
        k = len(rows)
        if k > self.tile_lanes:
            raise ValueError(
                f"{k} rows exceed the tile width {self.tile_lanes}")
        i = self._turn
        self._turn = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()     # its previous copy has landed
        buf = self._bufs[i].numpy()
        for j, r in enumerate(rows):
            buf[j] = r
        buf[k:] = 0.0
        if self.device.type != "cuda":
            return torch.from_numpy(buf.copy())
        out = self._bufs[i].to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._events[i] = ev
        return out

    def lane_mask(self, k: int) -> torch.Tensor:
        """(tile_lanes,) bool on the device with the first ``k`` lanes live."""
        return torch.arange(self.tile_lanes, device=self.device) < k
