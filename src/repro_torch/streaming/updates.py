"""Incremental index maintenance: batched insert and delete with localized
RNN-Descent repair (port of ``repro.streaming.updates``).

Insert (one batch of B points)
------------------------------
1. **Seed.** Beam-search the current graph for each new point (tombstone-
   aware, so only live vertices surface): its ``seed_k`` results become the
   new row's out-edges, plus ``batch_k`` brute-force nearest neighbours
   within the batch (two new points in one unexplored region cannot find
   each other through the old graph).
2. **Frontier.** The touched rows: the B new rows and every seeded
   candidate, a sorted-unique id buffer of F = B * (1 + seed_k) slots
   padded with the capacity as sentinel, so its shape depends on the batch,
   never on the corpus.
3. **Reverse repair and localized sweeps.** Each candidate v is offered the
   reverse edge (v -> new), and ``sweeps`` RNN-Descent sweeps run over the
   frontier rows: the fused RNG prune (``rng_prune``), the replacement
   edges (w -> v) scattered into frontier-local bucket tables
   (``bucket_scatter_tables(row_ids=frontier)``: table row f is vertex
   frontier[f]), and each frontier row merged with its bucket. Replacement
   edges whose destination is outside the frontier are dropped: the
   locality that keeps an insert's cost O(F).

Delete (one batch of ids)
-------------------------
Rows are tombstoned, not erased: their vectors and out-edges stay and keep
bridging traversal (search masks them out with ``valid=``). Each live
in-neighbour u of a deleted v is offered v's ``splice_k`` nearest
out-neighbours (d(u, w) computed fresh), merged into u's row and re-capped
under the RNG prune, within a budget of ``delete_fanout`` rows per deleted
id (rows past it keep their tombstone bridges until a later batch or
compact: bounded staleness, never a dangling edge).

Every update returns a new store and leaves its input untouched: the rows it
changes are written into private copies (with one scratch row past the
capacity, which takes the writes the reference drops with ``mode="drop"``),
and the arrays it does not change are shared.

Sharded updates (``mesh=``, a ``launch.mesh.Mesh``; every rank calls with the
same store and arguments): the store stays whole on every rank, as the
reference places it replicated. The frontier rows of an insert sweep
partition over the mesh's "rows" axes (``f_pad`` rounded up to a multiple of
D); each rank prunes its slice and scatters the replacement edges one
destination block at a time, and ``shard.exchange_scatter`` (the ring of the
sharded builds) hands each rank the combined bucket block of its own rows.
A delete partitions the affected rows, which need no exchange. Each rank
then ``all_gather``-s the rows it updated, so every rank writes the same
rows into its store. Per-row work is the single device's and the bucket
fold is an exact minimum, so every rank's store equals the single-device
store bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import as_tensor
from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.core import shard
from repro_torch.quant import encode_rows
from repro_torch.streaming.store import Store, active_mask, free_count

NEW = G.NEW
INF = float("inf")
# Lanes a tile of the seeding search. The reference seeds 256 lanes a tile;
# lanes are independent, so results do not depend on the tile, and the
# port's search pays its host time per tile iteration: wider tiles seed a
# batch in fewer iterations.
SEED_TILE = 1024


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Knobs for incremental maintenance. ``build`` carries the shared
    RNN-Descent parameters (metric, adjacency capacity M, merge): a store is
    built and repaired under one config."""

    build: rd.RNNDescentConfig = rd.RNNDescentConfig()
    seed_l: int = 64        # beam width of the insert seeding search
    seed_k: int = 24        # candidates harvested per inserted point
    seed_iters: int = 96    # max beam expansions during seeding
    search_k: int = 32      # Eq. 4 prefix limit during the seeding search
    batch_k: int = 8        # brute-force intra-batch neighbours per new point
    sweeps: int = 2         # localized RNN-Descent sweeps per insert batch
    splice_k: int = 8       # out-neighbours spliced per deleted vertex
    delete_fanout: int = 32  # repaired in-neighbour rows budget per deleted id

    def __post_init__(self):
        if not (1 <= self.seed_k <= self.seed_l):
            raise ValueError(
                f"seed_k={self.seed_k} must be in [1, seed_l={self.seed_l}]")
        if self.seed_k > self.build.capacity:
            raise ValueError(
                f"seed_k={self.seed_k} exceeds adjacency capacity "
                f"M={self.build.capacity}")
        if self.sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {self.sweeps}")
        if min(self.seed_iters, self.search_k, self.splice_k,
               self.delete_fanout) < 1:
            raise ValueError(
                "seed_iters, search_k, splice_k and delete_fanout must be "
                ">= 1")
        if self.batch_k < 0:
            raise ValueError(f"batch_k must be >= 0, got {self.batch_k}")

    @property
    def metric(self) -> str:
        return self.build.metric

    def seed_search_cfg(self) -> S.SearchConfig:
        return S.SearchConfig(
            l=self.seed_l, k=min(self.search_k, self.build.capacity),
            max_iters=self.seed_iters, metric=self.metric, topk=self.seed_k)


def _gather_rows(g: G.Graph, idx: torch.Tensor, cap: int) -> G.Graph:
    """Adjacency rows of a sentinel-padded id buffer (idx == cap marks
    padding; padded rows come back empty)."""
    cl = idx.clamp(max=cap - 1).long()
    live = (idx < cap)[:, None]
    return G.Graph(torch.where(live, g.neighbors[cl], -1),
                   torch.where(live, g.dists[cl], INF),
                   torch.where(live, g.flags[cl], G.OLD).to(torch.uint8))


def _writable(g: G.Graph) -> tuple[G.Graph, G.Graph]:
    """A private copy of ``g`` for in-place row writes, each field with one
    scratch row past the capacity (row ``cap`` takes the writes of sentinel
    ids). Returns (the buffers, their (cap, M) views the new store keeps)."""
    bufs = G.Graph(*(torch.cat([t, t[:1]]) for t in g))
    return bufs, G.Graph(*(t[:-1] for t in bufs))


def _scatter_rows_(bufs: G.Graph, idx: torch.Tensor, blk: G.Graph) -> None:
    """Write a row block into :func:`_writable` buffers (ids unique below
    the capacity; sentinels land in the scratch row)."""
    rows = idx.long()
    for dst, src in zip(bufs, blk):
        dst[rows] = src


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _n_dev(mesh) -> int:
    return 1 if mesh is None else shard.n_shards(mesh)


def _my_rows(idx: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a row-id buffer whose length divides by the
    shard count (the whole buffer without a mesh)."""
    if mesh is None:
        return idx
    lo, n_blk = shard.block_range(idx.shape[0], mesh)
    return idx[lo:lo + n_blk]


def _gather_blocks(blk: G.Graph, mesh) -> G.Graph:
    """Every rank's block of updated rows, concatenated in rank order (one
    ``all_gather`` of the three fields packed)."""
    if mesh is None:
        return blk
    return shard.gather_rows(blk, blk.n * _n_dev(mesh), mesh)


def _frontier_ids(slots: torch.Tensor, cand_ids: torch.Tensor, cap: int,
                  f_pad: int) -> torch.Tensor:
    """Sorted-unique frontier buffer: new slots and seeded candidates, with
    duplicates and invalid entries pushed to the ``cap`` sentinel tail."""
    cand = cand_ids.reshape(-1)
    raw = torch.cat([slots.int(), torch.where(cand >= 0, cand, cap).int()])
    f = torch.sort(raw).values
    dup = torch.zeros_like(f, dtype=torch.bool)
    dup[1:] = f[1:] == f[:-1]
    f = torch.sort(torch.where(dup | (f >= cap), cap, f)).values
    return torch.cat([f, f.new_full((f_pad - f.shape[0],), cap)])


def _local_rows(frontier: torch.Tensor, ids: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Vertex ids -> frontier-local row positions (f_pad = dropped)."""
    ids = ids.int().contiguous()
    pos = torch.searchsorted(frontier, ids).clamp(0, f_pad - 1)
    ok = (ids >= 0) & (frontier[pos] == ids)
    return torch.where(ok, pos, f_pad).int()


def _prune(x, blk: G.Graph, cfg: StreamingConfig):
    return rd.prune_rows(rd.gram_input(x, cfg.build), blk.neighbors, blk.dists, blk.flags,
                         cfg.build)


def _n_buckets(cfg: StreamingConfig, m: int) -> int:
    return cfg.build.n_buckets or G.default_buckets(m)


def _sweep_slice(x, g: G.Graph, f_slice, frontier, ex_rows, ex_ids, ex_d,
                 cfg: StreamingConfig, f_pad: int):
    """The rank-local half of a frontier sweep over the rows ``f_slice``
    (a slice of ``frontier``): the fused RNG prune, and the replacement
    edges (w -> v) with the extra offers ``ex_*`` as a scatter into
    frontier-local bucket tables. Returns (the slice's pruned rows,
    ``scatter_block(lo, f_blk)``: the tables of destination rows
    [lo, lo + f_blk))."""
    cap, m = g.neighbors.shape
    blk = _gather_rows(g, f_slice, cap)
    keep, red_w, red_d = _prune(x, blk, cfg)
    pruned = G.sort_rows(G.Graph(torch.where(keep, blk.neighbors, -1),
                                 torch.where(keep, blk.dists, INF),
                                 torch.zeros_like(blk.flags)))
    # replacement edges (w -> v): only frontier destinations merge
    rw = red_w.reshape(-1)
    rv = torch.where(red_w >= 0, blk.neighbors, -1).reshape(-1)
    rows = torch.cat([_local_rows(frontier, rw, f_pad), ex_rows])
    ids = torch.cat([rv, ex_ids])
    dist = torch.cat([red_d.reshape(-1), ex_d])
    # entries the tables drop anyway (most slots redirect nothing) are left
    # out before the scatter: the staged minimum does not depend on them
    sel = ((rows < f_pad) & (ids >= 0)).nonzero().squeeze(1)
    rows, ids, dist = rows[sel], ids[sel], dist[sel]
    flags = torch.full(ids.shape, NEW, dtype=torch.uint8, device=ids.device)
    nb = _n_buckets(cfg, m)

    def scatter_block(lo, f_blk):
        # the block restriction: rows outside [lo, lo + f_blk) fail the
        # range guard of the scatter
        return G.bucket_scatter_tables(rows - lo, ids, dist, flags, f_blk, nb,
                                       row_ids=frontier[lo:lo + f_blk])
    return pruned, scatter_block


def _merge_tables(pruned: G.Graph, tables) -> G.Graph:
    """Merge a row block with its combined bucket tables."""
    _, kt, it, ft = tables
    m = pruned.capacity
    return G.merge_rows_with_buckets(pruned, *G.decode_bucket_tables(kt, it, ft), m, m)


def _frontier_sweep(x, g: G.Graph, frontier, ex_rows, ex_ids, ex_d,
                    cfg: StreamingConfig, f_pad: int, mesh=None) -> G.Graph:
    """One localized RNN-Descent sweep over (this rank's slice of) the
    frontier: fused RNG prune, replacement edges routed into frontier-local
    bucket tables, bucket merge. ``ex_*`` carries extra candidate offers
    (the reverse edges v -> new on the first sweep, empty afterwards),
    replicated over the ranks: exact under the idempotent min-fold. Returns
    the new rows of the slice."""
    pruned, scatter_block = _sweep_slice(x, g, _my_rows(frontier, mesh), frontier,
                                         ex_rows, ex_ids, ex_d, cfg, f_pad)
    if mesh is None:
        return _merge_tables(pruned, scatter_block(0, f_pad))
    return _merge_tables(pruned, shard.exchange_scatter(mesh, f_pad, scatter_block))


def _graft(x, g: G.Graph, occupied, new_x, slots, cand_ids, cand_d,
           cfg: StreamingConfig, f_pad: int, mesh=None):
    """The insert's body: write the new rows, then reverse-repair and sweep
    the frontier (``f_pad`` a multiple of the mesh's shard count). Returns
    (x, graph, occupied) of the new store."""
    cap, m = g.neighbors.shape
    b, k = cand_ids.shape
    dev = x.device
    x2 = x.clone()
    x2[slots.long()] = new_x
    occ2 = occupied.clone()
    occ2[slots.long()] = True

    # intra-batch brute-force neighbours: new points in one unexplored
    # region cannot reach each other through the old graph
    bk = min(cfg.batch_k, b - 1)
    if bk > 0:
        bb = D.pairwise(new_x, new_x, cfg.metric)
        bb = bb.masked_fill(torch.eye(b, dtype=torch.bool, device=dev), INF)
        batch_d, bidx = D.topk_smallest(bb, bk)
        batch_ids = slots[bidx].int()                          # (B, bk) vertex ids
    else:
        batch_ids = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        batch_d = torch.zeros((b, 0), device=dev)

    # new rows: seeded candidates and batch neighbours, capped to M under the
    # row invariant (all NEW: the first sweep RNG-prunes them)
    cand_d = torch.where(cand_ids >= 0, cand_d, INF)
    row_ids = torch.cat([cand_ids.int(), batch_ids], dim=1)
    row_d = torch.cat([cand_d, batch_d], dim=1)
    new_rows = G.Graph(*G.row_topk(row_ids, row_d, torch.full(row_ids.shape, NEW,
                                                              dtype=torch.uint8, device=dev),
                                   m, m))
    bufs, g2 = _writable(g)
    _scatter_rows_(bufs, slots, new_rows)

    frontier = _frontier_ids(slots, cand_ids, cap, f_pad)
    # reverse offers: candidate v -> new slot (so the new points are found),
    # and batch neighbour j -> i (so intra-batch edges are mutual)
    off_rows = torch.cat([_local_rows(frontier, cand_ids.reshape(-1), f_pad),
                          _local_rows(frontier, batch_ids.reshape(-1), f_pad)])
    off_ids = torch.cat([slots[:, None].expand(b, k).reshape(-1),
                         slots[:, None].expand(b, bk).reshape(-1)]).int()
    off_d = torch.cat([cand_d.reshape(-1), batch_d.reshape(-1)])
    empty_i = torch.zeros((0,), dtype=torch.int32, device=dev)
    empty_d = torch.zeros((0,), device=dev)
    for t in range(cfg.sweeps):
        ex = (off_rows, off_ids, off_d) if t == 0 else (empty_i, empty_i, empty_d)
        rows = _frontier_sweep(x2, g2, frontier, *ex, cfg, f_pad, mesh)
        _scatter_rows_(bufs, frontier, _gather_blocks(rows, mesh))
    return x2, g2, occ2


def insert(store: Store, new_x, cfg: StreamingConfig,
           mesh=None) -> tuple[Store, np.ndarray]:
    """Insert a batch of vectors; returns ``(new_store, row_ids)`` (numpy
    int32 row ids). The store must have ``free_count(store) >= len(new_x)``:
    growth is :class:`repro_torch.streaming.index.StreamingANN`'s job. The
    input store is untouched, so snapshots taken before the call keep
    serving the previous epoch. ``mesh``: the seeding search runs
    query-sharded and the frontier sweeps row-sharded; every rank gets the
    single-device store."""
    new_x = as_tensor(new_x, store.x.device, torch.float32)
    b = new_x.shape[0]
    if b == 0:
        return store, np.zeros((0,), np.int32)
    if free_count(store) < b:
        raise ValueError(
            f"store has {free_count(store)} free rows < batch {b}: grow the "
            "store first (StreamingANN.insert does this automatically)")
    slots = (~store.occupied).nonzero().squeeze(1)[:b].int()

    active = active_mask(store)
    eps = S.default_entry_point(store.x, cfg.metric, valid=active)
    cand_ids, cand_d = S.search_tiled(store.x, store.graph, new_x, eps, cfg.seed_search_cfg(),
                                      tile_b=min(SEED_TILE, b), valid=active, mesh=mesh)
    f_pad = _round_up(b * (1 + cfg.seed_k), _n_dev(mesh))
    x2, g2, occ2 = _graft(store.x, store.graph, store.occupied, new_x, slots, cand_ids,
                          cand_d, cfg, f_pad, mesh)
    qx2 = store.qx
    if qx2 is not None:
        # encode into the frozen code space (trained at quantize time): a
        # row's codes never depend on when it arrived
        codes = qx2.codes.clone()
        codes[slots.long()] = encode_rows(new_x, qx2)
        qx2 = qx2._replace(codes=codes)
    return Store(x=x2, graph=g2, occupied=occ2, tombstone=store.tombstone,
                 epoch=store.epoch + 1, qx=qx2, remap=store.remap), slots.cpu().numpy()


# ------------------------------------------------------------------- delete
def _repair_block(x, g: G.Graph, tomb, a_idx, cfg: StreamingConfig) -> G.Graph:
    """Splice repair of the affected rows: drop edges into tombstones, offer
    each dropped vertex's ``splice_k`` nearest out-neighbours instead,
    re-cap under the RNG prune."""
    cap, m = g.neighbors.shape
    a = a_idx.shape[0]
    blk = _gather_rows(g, a_idx, cap)
    nb = blk.neighbors
    dead = (nb >= 0) & tomb[nb.clamp(min=0).long()]
    kept = G.sort_rows(G.Graph(torch.where(dead, -1, nb),
                               torch.where(dead, INF, blk.dists),
                               torch.where(dead, G.OLD, blk.flags).to(torch.uint8)))
    sk = min(cfg.splice_k, m)
    # v's out-neighbour prefix (rows are distance-sorted, so [:sk] is its sk
    # nearest), for the dead entries only
    spl = g.neighbors[:, :sk][nb.clamp(min=0).long()]              # (A, M, sk)
    spl = torch.where(dead[:, :, None], spl, -1)
    spl = torch.where((spl >= 0) & ~tomb[spl.clamp(min=0).long()], spl, -1).reshape(a, -1)
    # the splice offers, as a flat list of its valid entries (the tables
    # drop the rest); their distances d(u, w) are computed fresh
    rows, cols = (spl >= 0).nonzero(as_tuple=True)
    ids = spl[rows, cols]
    ds = D.gather_dists(x, a_idx[rows], ids, cfg.metric)
    b_ids, b_d, b_f = G.bucket_scatter(
        rows, ids, ds, torch.full(ids.shape, NEW, dtype=torch.uint8, device=ids.device), a,
        _n_buckets(cfg, m), row_ids=a_idx)
    merged = G.merge_rows_with_buckets(kept, b_ids, b_d, b_f, m, m)
    keep, _, _ = _prune(x, merged, cfg)
    return G.sort_rows(G.Graph(torch.where(keep, merged.neighbors, -1),
                               torch.where(keep, merged.dists, INF),
                               torch.zeros_like(merged.flags)))


def delete(store: Store, ids, cfg: StreamingConfig, mesh=None) -> Store:
    """Tombstone a batch of row ids and splice-repair their live
    in-neighbours; returns the new store (input untouched).

    Ids that are out of range, unoccupied or already tombstoned are skipped
    (delete is idempotent; a batch of nothing returns the store itself). The
    repair budget is ``delete_fanout`` affected rows per deleted id.
    ``mesh``: the affected rows partition over the ranks (their buffer
    padded with sentinels to a multiple of D; the rows repaired are the
    single device's) and every rank gets the single-device store."""
    cap = store.capacity
    dev = store.x.device
    ids = torch.as_tensor(np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
                          .reshape(-1).astype(np.int64), device=dev).unique()
    ids = ids[(ids >= 0) & (ids < cap)]
    ids = ids[store.occupied[ids] & ~store.tombstone[ids]]
    bd = ids.shape[0]
    if bd == 0:
        return store
    tomb_new = store.tombstone.clone()
    tomb_new[ids] = True

    nbrs = store.graph.neighbors
    newly = torch.zeros((cap,), dtype=torch.bool, device=dev)
    newly[ids] = True
    # one scan of the whole adjacency (int32 ids index directly)
    hit = newly.index_select(0, nbrs.clamp(min=0).reshape(-1)).view(nbrs.shape)
    affected = ((nbrs >= 0) & hit).any(dim=1) & store.occupied & ~tomb_new
    aff = affected.nonzero().squeeze(1)
    budget = min(cap, max(bd * cfg.delete_fanout, 1))
    take = min(aff.shape[0], budget)
    a_idx = torch.full((_round_up(budget, _n_dev(mesh)),), cap, dtype=torch.int32, device=dev)
    a_idx[:take] = aff[:take].int()

    bufs, g2 = _writable(store.graph)
    rows = _repair_block(store.x, store.graph, tomb_new, _my_rows(a_idx, mesh), cfg)
    _scatter_rows_(bufs, a_idx, _gather_blocks(rows, mesh))
    return Store(x=store.x, graph=g2, occupied=store.occupied, tombstone=tomb_new,
                 epoch=store.epoch + 1, qx=store.qx, remap=store.remap)
