"""Capacity-padded corpus store for the streaming (dynamic) index (port of
``repro.streaming.store``).

A churning corpus lives in a :class:`Store`: every array is padded to a
power-of-two ``capacity``, and two row masks track liveness:

``occupied``   the row holds a vector (inserted at some point). Occupied rows
               take part in graph traversal whether or not they are
               tombstoned; unoccupied rows are inert (zero vector, empty
               adjacency, no in-edges).

``tombstone``  the row was deleted (a subset of ``occupied``). Tombstoned rows
               stay traversable (their out-edges survive and other rows may
               still point at them, so they bridge beam search) but never
               surface in results (``search_tiled(valid=...)``);
               :func:`compact` rebuilds the store without them.

Doubling the capacity keeps growth (a copy of every array) to O(log n)
events, at most twice the footprint of an exact-fit corpus: ``d * 4`` (x) +
``M * 9`` (adjacency) + 2 (masks) bytes a row.

Every function here is pure: it returns a new Store and leaves its input
untouched (tensors that do not change are shared, never written), which is
what keeps the epoch snapshots of streaming/index.py safe. Everything runs
on the store's device; :func:`compact`, which the reference runs in numpy
on the host, runs there too, with the same result.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.quant import Quantization, QuantizedCorpus, encode_corpus


class Store(NamedTuple):
    """x: (C, d) f32 (zeros in unoccupied rows) | graph: (C, M) adjacency |
    occupied / tombstone: (C,) bool | epoch: () int32 update counter |
    qx: optional quantized codes | remap: optional last-compaction remap
    (both trailing and None by default, so a checkpoint of a store that
    never held them has no leaf for them).

    A quantized store keeps both representations: ``qx.codes`` serve the
    coded search (and grow, compact and checkpoint like ``x``), ``x`` the
    exact rerank tail and the f32 update sweeps.

    ``remap`` is the survivor map of the latest :func:`compact`:
    ``remap[old_row] -> new_row`` (-1 for removed rows), sized to the
    capacity before it, so a save/restore between a compact and the
    translation of external ids keeps it."""

    x: torch.Tensor
    graph: G.Graph
    occupied: torch.Tensor
    tombstone: torch.Tensor
    epoch: torch.Tensor
    qx: QuantizedCorpus | None = None
    remap: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def m(self) -> int:
        return self.graph.neighbors.shape[1]


def next_capacity(n: int) -> int:
    """Smallest power of two >= max(n, 8)."""
    return 1 << max(3, (n - 1).bit_length())


def active_mask(store: Store) -> torch.Tensor:
    """(C,) bool: rows that may surface in search results."""
    return store.occupied & ~store.tombstone


def live_count(store: Store) -> int:
    return int(active_mask(store).sum())


def occupied_count(store: Store) -> int:
    return int(store.occupied.sum())


def free_count(store: Store) -> int:
    """Rows available for insertion. Tombstoned rows are not free until
    :func:`compact`: in-edges may still route traffic through them."""
    return store.capacity - occupied_count(store)


def _pad_rows(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    if pad == 0:
        return t
    return torch.cat([t, t.new_full((pad, *t.shape[1:]), value)])


def _pad_graph(g: G.Graph, cap: int) -> G.Graph:
    pad = cap - g.n
    return G.Graph(_pad_rows(g.neighbors, pad, -1), _pad_rows(g.dists, pad, float("inf")),
                   _pad_rows(g.flags, pad, G.OLD))


def _pad_codes(qx: QuantizedCorpus | None, pad: int) -> QuantizedCorpus | None:
    """Capacity-pad the code rows with zeros (unoccupied rows are
    unreachable); the code space's parameters are untouched."""
    if qx is None or pad == 0:
        return qx
    return qx._replace(codes=_pad_rows(qx.codes, pad, 0))


def _row_mask(n: int, cap: int, device) -> torch.Tensor:
    return torch.arange(cap, device=device) < n


def from_built(x: torch.Tensor, g: G.Graph, capacity: int | None = None,
               qx: QuantizedCorpus | None = None) -> Store:
    """Wrap a batch-built (x, graph) pair into a padded store (rows [0, n)
    occupied, nothing tombstoned, epoch 0) on x's device. ``qx``: optional
    (n, .) codes from the same encode the builder used, padded alongside."""
    n = x.shape[0]
    if g.n != n:
        raise ValueError(
            f"graph has {g.n} rows but the corpus has {n}: from_built "
            "expects the (x, graph) pair of one batch build")
    if qx is not None and qx.codes.shape[0] != n:
        raise ValueError(
            f"qx holds {qx.codes.shape[0]} code rows but the corpus has {n}")
    cap = next_capacity(n if capacity is None else max(capacity, n))
    dev = x.device
    return Store(
        x=_pad_rows(x.float(), cap - n, 0.0),
        graph=_pad_graph(g, cap),
        occupied=_row_mask(n, cap, dev),
        tombstone=torch.zeros((cap,), dtype=torch.bool, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        qx=_pad_codes(qx, cap - n),
    )


def grow(store: Store, min_capacity: int) -> Store:
    """Re-pad every array to ``next_capacity(min_capacity)``; never
    shrinks."""
    cap = store.capacity
    new_cap = next_capacity(min_capacity)
    if new_cap <= cap:
        return store
    pad = new_cap - cap
    return Store(
        x=_pad_rows(store.x, pad, 0.0),
        graph=_pad_graph(store.graph, new_cap),
        occupied=_pad_rows(store.occupied, pad, False),
        tombstone=_pad_rows(store.tombstone, pad, False),
        epoch=store.epoch,
        qx=_pad_codes(store.qx, pad),
        remap=store.remap,
    )


def compact(store: Store) -> tuple[Store, np.ndarray]:
    """Rebuild the store without tombstoned (and unoccupied) rows.

    Survivors are renumbered densely from 0 in ascending old-row order;
    edges into removed rows are dropped (the delete-time splice already
    bridged around them) and each row is re-sorted to the row invariant.
    Returns ``(new_store, remap)`` with ``remap[old_row]`` the new row id or
    -1 (numpy int32); ``new_store.remap`` holds the same map."""
    dev = store.x.device
    old_ids = active_mask(store).nonzero().squeeze(1)
    n_new = old_ids.shape[0]
    cap2 = next_capacity(n_new)
    remap = torch.full((store.capacity,), -1, dtype=torch.int32, device=dev)
    remap[old_ids] = torch.arange(n_new, dtype=torch.int32, device=dev)

    g = store.graph
    nb = g.neighbors[old_ids]
    nb2 = torch.where(nb >= 0, remap.index_select(0, nb.clamp(min=0).reshape(-1))
                      .view(nb.shape), -1)
    g2 = G.sort_rows(G.Graph(
        neighbors=nb2,
        dists=torch.where(nb2 >= 0, g.dists[old_ids], float("inf")),
        flags=torch.where(nb2 >= 0, g.flags[old_ids], G.OLD).to(torch.uint8),
    ))
    qx2 = None
    if store.qx is not None:
        qx2 = _pad_codes(store.qx._replace(codes=store.qx.codes[old_ids]), cap2 - n_new)
    new = Store(
        x=_pad_rows(store.x[old_ids], cap2 - n_new, 0.0),
        graph=_pad_graph(g2, cap2),
        occupied=_row_mask(n_new, cap2, dev),
        tombstone=torch.zeros((cap2,), dtype=torch.bool, device=dev),
        epoch=store.epoch + 1,
        qx=qx2,
        remap=remap,
    )
    return new, remap.cpu().numpy()


def quantize_store(store: Store, quant: Quantization) -> Store:
    """Attach (or retrain) quantized codes for an existing store: the code
    space is trained on the live rows only (padding and tombstones must not
    distort it), codes are emitted for every row. Bumps no epoch."""
    if not quant.is_coded:
        return store._replace(qx=None)
    live = active_mask(store).nonzero().squeeze(1)
    return store._replace(qx=encode_corpus(store.x, quant, train_rows=store.x[live]))
