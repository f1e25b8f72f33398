"""StreamingANN: a dynamic ANN index (insert, delete, search, compact,
save/restore) over the capacity-padded :class:`repro_torch.streaming.store.Store`
(port of ``repro.streaming.index``).

Epoch-snapshot serving
----------------------
No update writes into a store another reader may hold: each
(:func:`repro_torch.streaming.updates.insert` / ``delete`` / ``compact``)
builds the next store off to the side, and ``StreamingANN`` commits it with
one Python reference swap, bumping ``epoch``. A reader that captured
``snapshot()`` (or entered ``search()``, which reads the reference once)
keeps serving the whole graph of its epoch however many updates commit
meanwhile.

Serving is tombstone-aware: ``search`` passes the store's live-row mask to
``search_tiled(valid=)`` (deleted rows are traversed as bridges but never
surface; capacity padding is unreachable) and seeds from live rows only.
Persistence rides repro_torch.checkpoint: the whole store (vectors,
adjacency, masks, epoch, codes, remap) saves as host arrays in the
reference's format and restores onto a device, or onto a mesh of any size.

Mesh composition (``mesh=``, a ``launch.mesh.Mesh``): every rank of the mesh
holds one ``StreamingANN`` with the whole store on its device (the
reference's replicated placement) and calls each method with the same
arguments. Construction runs the row-sharded build, updates the sharded
frontier sweeps and delete repair of ``updates``, ``compact``'s repair
sweeps the sharded ``update_neighbors``, and search either sharding of
``search_tiled``; every result equals the single device's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import as_tensor, checkpoint
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.quant import QuantizedCorpus, encode_corpus
from repro_torch.streaming import store as ST
from repro_torch.streaming import updates as U


def _place(st: ST.Store, mesh) -> ST.Store:
    """The store on the mesh's device, whole on every rank (the reference
    commits it replicated, ``P()``; update programs partition internally)."""
    if mesh is None:
        return st
    dev = mesh.device

    def put(t):
        return None if t is None else t.to(dev)
    qx = None if st.qx is None else QuantizedCorpus(*map(put, st.qx))
    return ST.Store(put(st.x), G.Graph(*map(put, st.graph)), put(st.occupied),
                    put(st.tombstone), put(st.epoch), qx, put(st.remap))


@dataclasses.dataclass
class StreamingANN:
    """A dynamic index on the device of its store (the mesh's device when
    it is bound to one).

    >>> ann = StreamingANN.from_corpus(x, cfg=StreamingConfig(...))
    >>> new_ids = ann.insert(new_vectors)       # row ids of the new points
    >>> ann.delete(new_ids[:8])                 # tombstone + splice repair
    >>> ids, dists = ann.search(queries, S.SearchConfig(l=32, topk=10))
    >>> remap = ann.compact()                   # physically drop tombstones
    >>> ann.save("ckpts/stream"); StreamingANN.restore("ckpts/stream")
    """

    store: ST.Store
    cfg: U.StreamingConfig
    mesh: Any = None

    def __post_init__(self):
        self.store = _place(self.store, self.mesh)

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def from_corpus(cls, x, cfg: U.StreamingConfig | None = None,
                    generator: torch.Generator | None = None,
                    capacity: int | None = None,
                    device: str | torch.device = "cuda", mesh=None) -> "StreamingANN":
        """Batch-build the initial graph (``rnn_descent.build``, row-sharded
        over ``mesh`` when given; ``x`` as a tensor runs on its device,
        numpy input is placed on ``device``, or on the mesh's) and wrap it
        into a padded store."""
        cfg = cfg if cfg is not None else U.StreamingConfig()
        x = as_tensor(x, mesh.device if mesh is not None else device, torch.float32)
        g = rd.build(x, cfg.build, generator, mesh=mesh)
        # the builder's own encode (deterministic in x and the config), so
        # the serving codes are the geometry the graph was built over
        qx = encode_corpus(x, cfg.build.quant) if cfg.build.quant.is_coded else None
        return cls(store=ST.from_built(x, g, capacity=capacity, qx=qx), cfg=cfg, mesh=mesh)

    # -------------------------------------------------------------- queries
    def snapshot(self) -> tuple[int, ST.Store]:
        """(epoch, store): no update writes into the store, so holding it
        serves a consistent graph across any number of later updates."""
        st = self.store
        return int(st.epoch), st

    def search(self, queries, cfg: S.SearchConfig | None = None, entry_points=None,
               tile_b: int = 256, shard: str = "queries", with_stats: bool = False,
               lane_valid=None, store: ST.Store | None = None):
        """Tombstone-aware search over the current epoch's store: deleted
        rows route traffic but never appear in the top-k; lanes reaching
        fewer than topk live vertices pad with (-1, +inf). ``shard``,
        ``with_stats`` and ``lane_valid`` pass through to
        :func:`repro_torch.core.search.search_tiled` with the bound mesh
        (``shard="corpus"`` needs one); ``store=`` searches an explicit
        snapshot (from :meth:`snapshot`) instead of the live reference."""
        st = self.store if store is None else store          # one read = one epoch
        cfg = cfg if cfg is not None else S.SearchConfig()
        qx = None
        if cfg.quant.is_coded:
            if st.qx is None:
                raise ValueError(
                    f"search config requests quant mode {cfg.quant.mode!r} "
                    "but the store holds no codes: call "
                    ".quantize(Quantization(...)) first")
            if st.qx.mode != cfg.quant.mode:
                raise ValueError(
                    f"search config requests quant mode {cfg.quant.mode!r} "
                    f"but the store's codes are {st.qx.mode!r}")
            qx = st.qx
        valid = ST.active_mask(st)
        if entry_points is None:
            entry_points = S.default_entry_point(st.x, cfg.metric, valid=valid)
        return S.search_tiled(st.x, st.graph, queries, entry_points, cfg, tile_b=tile_b,
                              with_stats=with_stats, lane_valid=lane_valid, qx=qx,
                              valid=valid, mesh=self.mesh, shard=shard)

    # -------------------------------------------------------------- updates
    def insert(self, new_x) -> np.ndarray:
        """Insert a batch; returns the assigned row ids. Grows the store
        (power-of-two capacity) when free rows run out, then commits the
        updated store."""
        st = self.store
        new_x = as_tensor(new_x, st.x.device, torch.float32)
        b = new_x.shape[0]
        if ST.free_count(st) < b:
            st = ST.grow(st, ST.occupied_count(st) + b)
        st, slots = U.insert(st, new_x, self.cfg, mesh=self.mesh)
        self.store = st                      # atomic epoch swap
        return slots

    def delete(self, ids) -> np.ndarray:
        """Tombstone and splice-repair a batch of row ids.

        Returns a bool mask aligned with ``ids``: True where the id was a
        live row at call entry (this call tombstoned it), False where it was
        already tombstoned (the repeat is a no-op). Ids never handed out
        (negative, beyond the capacity, or naming an unoccupied row) raise
        ``IndexError``: they mean a corrupted external id book. Duplicate ids
        in one batch all report the liveness before the call."""
        st = self.store
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu()
        ids_np = np.asarray(ids).reshape(-1).astype(np.int64)
        cap = st.capacity
        oob = (ids_np < 0) | (ids_np >= cap)
        if np.any(oob):
            bad = ids_np[oob][:8]
            raise IndexError(
                f"delete ids out of range [0, {cap}): {bad.tolist()}"
                f"{'...' if int(np.sum(oob)) > 8 else ''}; row ids come "
                "from insert()/from_corpus and never leave the capacity")
        rows = torch.as_tensor(ids_np, device=st.x.device)
        occ = st.occupied[rows].cpu().numpy()
        if not occ.all():
            bad = ids_np[~occ][:8]
            raise IndexError(
                f"delete ids name unoccupied rows: {bad.tolist()}"
                f"{'...' if int(np.sum(~occ)) > 8 else ''}; these were never "
                "assigned by insert() (stale ids from before a compact()? "
                "translate through last_remap)")
        newly = ~st.tombstone[rows].cpu().numpy()
        self.store = U.delete(st, ids_np, self.cfg, mesh=self.mesh)
        return newly

    def compact(self, repair_sweeps: int = 1) -> np.ndarray:
        """Physically drop tombstoned rows (dense renumbering); returns the
        old-row -> new-row remap (-1 for removed rows), which also persists
        on the store (``last_remap``) through save/restore. ``repair_sweeps``
        full ``update_neighbors`` passes then re-knit regions that leaned on
        tombstone bridges (0 to skip), row-sharded over the bound mesh (each
        rank sweeps its rows, then the rows are gathered). Traced, each
        repair sweep is a ``streaming/repair`` span that waits on the card
        once, like a build's sweep, for the prune and merge spans in it."""
        from repro_torch.obs import cudahooks as _ch
        from repro_torch.obs import trace as _tr
        st, remap = ST.compact(self.store)
        for _ in range(repair_sweeps):
            with _tr.span("streaming/repair") as sp, _ch.span_costs(sp, st.x.device):
                if self.mesh is not None:
                    from repro_torch.core import shard
                    g = shard.rnn_update_neighbors(rd.gram_input(st.x, self.cfg.build),
                                                   shard.local_rows(st.graph, self.mesh),
                                                   self.cfg.build, self.mesh)
                    g = shard.gather_rows(g, st.graph.n, self.mesh)
                else:
                    g = rd.update_neighbors(st.x, st.graph, self.cfg.build)
            st = st._replace(graph=g)
        self.store = st
        return remap

    def quantize(self, quant) -> None:
        """Attach (or retrain, or with a non-coded mode drop) quantized codes
        for the current store (:func:`repro_torch.streaming.store.quantize_store`).
        Searches whose config carries the same coded mode then score the
        codes, with the exact-f32 rerank tail."""
        self.store = ST.quantize_store(self.store, quant)

    # ---------------------------------------------------------- persistence
    def save(self, ckpt_dir: str, step: int | None = None) -> None:
        """Atomic-commit save of the whole store (host arrays). Default step:
        the current epoch. Under a mesh rank 0 writes and every rank returns
        once it has."""
        st = self.store
        if self.mesh is None or self.mesh.rank == 0:
            checkpoint.save(ckpt_dir, int(st.epoch) if step is None else step, st)
        if self.mesh is not None:
            from repro_torch.distributed import comm as C
            C.psum(torch.zeros((), device=self.mesh.device), self.mesh, self.mesh.axis_names)

    @classmethod
    def restore(cls, ckpt_dir: str, cfg: U.StreamingConfig | None = None,
                step: int | None = None, device: str | torch.device = "cuda",
                mesh=None) -> "StreamingANN":
        """Elastic restore onto ``mesh`` (any size, not necessarily the one
        the store was saved from) or, without one, onto ``device``:
        tombstones, capacity padding, the epoch, codes and the last remap
        all round-trip."""
        if step is None:
            step = checkpoint.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
        # the optional subtrees (codes, remap) have no leaves when absent, so
        # the manifest's names decide the structure of the like-tree
        names = set(checkpoint.manifest_names(ckpt_dir, step))
        if ".qx.codebooks" in names:
            qx_like = QuantizedCorpus(codes=0, codebooks=0)
        elif ".qx.scale" in names:
            qx_like = QuantizedCorpus(codes=0, scale=0, zero=0)
        else:
            qx_like = None
        like = ST.Store(x=0, graph=G.Graph(0, 0, 0), occupied=0, tombstone=0, epoch=0,
                        qx=qx_like, remap=0 if ".remap" in names else None)
        st = checkpoint.restore(ckpt_dir, step, like,
                                device=mesh.device if mesh is not None else device)
        if cfg is None:
            m = st.graph.neighbors.shape[1]
            cfg = U.StreamingConfig(build=rd.RNNDescentConfig(capacity=m, r=min(96, m)),
                                    seed_k=min(24, m))
        return cls(store=st, cfg=cfg, mesh=mesh)

    # ------------------------------------------------------------ inspection
    @property
    def epoch(self) -> int:
        return int(self.store.epoch)

    @property
    def live(self) -> int:
        return ST.live_count(self.store)

    @property
    def capacity(self) -> int:
        return self.store.capacity

    @property
    def last_remap(self) -> np.ndarray | None:
        """The latest :meth:`compact`'s old-row -> new-row map (-1 = removed),
        or None if the store was never compacted. Survives save/restore."""
        rm = self.store.remap
        return None if rm is None else rm.cpu().numpy()

    def stats(self) -> dict[str, Any]:
        st = self.store
        return {
            "epoch": int(st.epoch),
            "capacity": st.capacity,
            "occupied": ST.occupied_count(st),
            "live": ST.live_count(st),
            "tombstones": int(st.tombstone.sum()),
        }
