"""Streaming (dynamic) index: incremental insert/delete with tombstone-aware
serving over the RNN-Descent graph (port of ``repro.streaming``).

* :mod:`repro_torch.streaming.store`   capacity-padded corpus, graph, masks
* :mod:`repro_torch.streaming.updates` batched insert / delete repair
* :mod:`repro_torch.streaming.index`   the StreamingANN API (epoch snapshots,
  persistence)
"""
from repro_torch.streaming.index import StreamingANN
from repro_torch.streaming.store import Store, active_mask, from_built
from repro_torch.streaming.updates import StreamingConfig, delete, insert

__all__ = [
    "StreamingANN", "Store", "StreamingConfig", "active_mask", "from_built",
    "delete", "insert",
]
