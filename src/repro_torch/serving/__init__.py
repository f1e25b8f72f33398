"""Serving front end: asynchronous request admission over a streaming index
(port of ``repro.serving``).

Everything below this package is a batch call: hand ``search_tiled`` a
(B, d) block and wait. A serving workload is the opposite shape — queries
arrive one at a time at unpredictable instants, each with a latency budget,
while inserts and deletes trickle in concurrently. This package turns the
first shape into the second and keeps two invariants:

* **No kernel builds in steady state.** The admission queue
  (:mod:`repro_torch.serving.admission`) coalesces requests into tiles of a
  *constant* ``tile_lanes`` width and dispatches partially-full tiles with
  the vacant lanes masked via ``search_tiled(lane_valid=)``, and the writer
  commits fixed-size batches, so after a warm-up that touches each shape
  once a session builds no kernel and compiles nothing.

* **Epoch-consistent reads under concurrent writes.** The writer path
  (:mod:`repro_torch.serving.writer`) batches caller inserts/deletes into
  fixed-size commits behind :class:`repro_torch.streaming.index.StreamingANN`'s
  single-reference epoch swap; every dispatched tile pins the snapshot it
  searches, so a tile in flight keeps its internally-consistent graph no
  matter how many commits land meanwhile.

Module map:

* :mod:`repro_torch.serving.admission` — size-vs-deadline admission queue
* :mod:`repro_torch.serving.staging`   — ring-buffered host→device staging
* :mod:`repro_torch.serving.writer`    — batched multi-writer commit path
* :mod:`repro_torch.serving.telemetry` — SLO accounting (p50/p95/p99, QPS,
  occupancy / queue-depth histograms, epoch staleness)
* :mod:`repro_torch.serving.frontend`  — the event loop tying them together
* :mod:`repro_torch.serving.loadgen`   — deterministic open-loop load
  generator

A mesh-bound index serves from rank 0, which owns admission, the clock and
the writer; the other ranks follow its steps (``ServingFrontend.follow``).
"""
from repro_torch.serving.admission import AdmissionConfig, AdmissionQueue
from repro_torch.serving.frontend import ServingConfig, ServingFrontend
from repro_torch.serving.loadgen import LoadSpec, arrival_times, run_session
from repro_torch.serving.staging import DoubleBuffer
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.writer import BatchedWriter, WriterConfig, WriteTicket

__all__ = [
    "AdmissionConfig", "AdmissionQueue", "BatchedWriter", "DoubleBuffer",
    "LoadSpec", "ServingConfig", "ServingFrontend", "Telemetry",
    "WriteTicket", "WriterConfig", "arrival_times", "run_session",
]
