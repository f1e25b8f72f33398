"""NSG-style refinement baseline (Fu et al., PVLDB'19), simplified; port of
``repro.core.nsg_style``.

Build an approximate K-NN graph with NN-Descent, expand each row to a pool
of its own and its neighbours' neighbours, keep the C nearest, prune them
with the RNG Strategy (Alg. 3; the ``rng_prune`` kernel on the card, whose
rows here are C = 132 wide) and cap the out-degree at R, add capped reverse
edges, then repair connectivity: every vertex unreachable from the
navigating node gets an in-edge from its nearest reachable vertex (the scan
for it reads only the reachable vertices).

The expansion pools hold k + k² ids a row (4160 at K = 64), so it walks the
rows in chunks under ``EXPAND_BUDGET`` pool entries and forms distances only
for the deduplicated ids.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor
from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.core import nn_descent as nnd
from repro_torch.core.rng import rng_prune_rows
from repro_torch.kernels.pairwise_l2 import ops as pl2
from repro_torch.quant import Quantization, prep_corpus

EXPAND_BUDGET = 1 << 23   # pool entries of one expansion chunk (2016 rows at K = 64)
SCAN_BUDGET = 1 << 26     # distances of one block of the repair's scan


@dataclasses.dataclass(frozen=True)
class NSGStyleConfig:
    """Paper §5.1: NSG R=32, L=64, C=132 on top of NN-Descent K=64."""

    r: int = 32
    c: int = 132         # candidate pool per vertex before the RNG prune
    knn: nnd.NNDescentConfig = dataclasses.field(default_factory=nnd.NNDescentConfig)
    metric: str = "l2"
    chunk: int = 256     # rows per block of the reference's expansion (the port's: EXPAND_BUDGET)
    merge: str = "bucketed"        # "bucketed" (scatter) | "sort" (oracle)
    n_buckets: int | None = None
    quant: Quantization = Quantization()  # int8/pq: the whole pipeline runs over
                                          # the decoded corpus (one encode)

    def __post_init__(self):
        if self.merge not in G.MERGE_MODES:
            raise ValueError(
                f"unknown merge mode {self.merge!r}: expected one of "
                f"{G.MERGE_MODES}")
        if not isinstance(self.quant, Quantization):
            raise ValueError(
                f"quant must be a repro_torch.quant.Quantization, got "
                f"{type(self.quant).__name__}")
        if self.quant.is_coded and self.knn.quant.is_coded:
            raise ValueError(
                "set quant on NSGStyleConfig only (it preps the corpus once "
                "for the whole pipeline); knn.quant would re-encode the "
                "already-decoded x_hat")


def reachable_mask(g: G.Graph, entry, iters: int) -> torch.Tensor:
    """Vertices reachable from ``entry`` within ``iters`` BFS rounds (it
    stops at the fixpoint, which gives the same set)."""
    n = g.n
    valid = g.neighbors >= 0
    nbrs = torch.where(valid, g.neighbors, 0).reshape(-1).long()
    reach = torch.zeros((n,), dtype=torch.bool, device=g.neighbors.device)
    reach[int(entry)] = True
    for _ in range(iters):
        frontier = (reach[:, None] & valid).reshape(-1).to(torch.int32)
        marks = torch.zeros((n,), dtype=torch.int32, device=reach.device) \
            .scatter_add_(0, nbrs, frontier) > 0
        new = reach | marks
        if bool((new == reach).all()):
            break
        reach = new
    return reach


def _nearest(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             metric: str) -> torch.Tensor:
    """For each id in ``rows``, the nearest of the ids ``cols`` (ascending),
    the lowest on ties, as ``jnp.argmin`` over a row masked to ``cols``
    picks it; where every distance is +inf, vertex 0, as that argmin does."""
    a, b = x[rows.long()].contiguous(), x[cols].contiguous()
    d = pl2.pairwise_l2(a, b) if metric == "l2" else D.pairwise(a, b, metric)
    at = torch.argmin(d, dim=1)                 # the first minimum
    best = torch.gather(d, 1, at[:, None])[:, 0]
    return torch.where(best < float("inf"), cols[at], 0).int()


def repair_sources(x: torch.Tensor, reach: torch.Tensor, metric: str = "l2",
                   tile: int = 512) -> torch.Tensor:
    """(n,) int32: for each vertex outside ``reach``, its nearest vertex in
    ``reach``; -1 for the vertices in it. The scan covers only the
    reachable columns, in blocks of at least ``tile`` rows
    (``SCAN_BUDGET`` distances a block)."""
    unreached = (~reach).nonzero().squeeze(1).int()
    cols = reach.nonzero().squeeze(1)
    src = torch.full(reach.shape, -1, dtype=torch.int32, device=x.device)
    rows = max(tile, SCAN_BUDGET // max(1, cols.shape[0]))
    for s in range(0, unreached.shape[0], rows):
        u = unreached[s:s + rows]
        src[u.long()] = _nearest(x, u, cols, metric)
    return src


def ensure_reachable(x: torch.Tensor, g: G.Graph, entry, metric: str = "l2",
                     bfs_iters: int = 64, tile: int = 512, merge: str = "sort",
                     n_buckets: int | None = None) -> G.Graph:
    """NSG-style connectivity repair: every vertex unreachable from
    ``entry`` receives an in-edge from its nearest *reachable* vertex
    (:func:`repair_sources`). It merges with the exact ``merge="sort"`` by
    default: a bucket collision would drop a repair edge that no later pass
    offers again. A row that receives more repair edges than it has room
    for keeps its nearest entries, so the repair does not promise a
    connected graph."""
    n = g.n
    src = repair_sources(x, reachable_mask(g, entry, bfs_iters), metric, tile)
    dst = torch.where(src >= 0, torch.arange(n, dtype=torch.int32, device=x.device), -1)
    dist = D.gather_dists(x, src, dst, metric)
    return G.merge_candidate_edges(g, src, dst, dist, merge=merge, n_buckets=n_buckets)


def _expand_chunk(x, nbrs, cid, base, c: int, metric: str):
    """Expansion of one block of rows: ``cid`` (C0, k) their neighbours,
    ``base`` (C0,) their vertex ids (-1: an empty row)."""
    c0, k = cid.shape
    hop2 = torch.where(cid[:, :, None] >= 0, nbrs[cid.clamp(min=0).long()], -1) \
        .reshape(c0, -1)
    pool = torch.cat([cid, hop2], dim=1)
    pool = torch.where(pool == base[:, None], -1, pool)        # drop self
    pool = G.dedup_row_ids(pool)                                # sorted; repeats -1
    d = torch.full(pool.shape, float("inf"), device=x.device)
    at = (pool >= 0).nonzero()
    d[at[:, 0], at[:, 1]] = D.gather_dists(x, base[at[:, 0]], pool[at[:, 0], at[:, 1]], metric)
    vals, order = D.topk_smallest(d, c)
    ids = torch.gather(pool, 1, order)
    return torch.where(torch.isfinite(vals), ids, -1), vals


def expand_candidates(x: torch.Tensor, g: G.Graph, c: int, metric: str = "l2",
                      chunk: int | None = None, rows: torch.Tensor | None = None):
    """NSG candidate acquisition: pool = own row ∪ 2-hop rows, deduplicated,
    nearest ``c`` kept, ties toward the lower id (``lax.top_k``'s rule over
    the id-sorted pool). ``rows``: optional (R,) vertex ids to expand (-1
    gives an empty row); default every vertex. ``chunk``: rows a block
    (default: ``EXPAND_BUDGET`` pool entries); the rows are independent, so
    it moves no result. Returns (ids (R, c) int32, dists (R, c) f32)."""
    n, k = g.neighbors.shape
    if rows is None:
        rows = torch.arange(n, dtype=torch.int32, device=g.neighbors.device)
    rows = rows.int()
    chunk = chunk or max(1, EXPAND_BUDGET // (k + k * k))
    ids, dists = [], []
    for s in range(0, rows.shape[0], chunk):
        base = rows[s:s + chunk]
        cid = torch.where(base[:, None] >= 0, g.neighbors[base.clamp(min=0).long()], -1)
        i, d = _expand_chunk(x, g.neighbors, cid, base, c, metric)
        ids.append(i)
        dists.append(d)
    if not ids:
        return (torch.zeros((0, c), dtype=torch.int32, device=x.device),
                torch.zeros((0, c), device=x.device))
    return torch.cat(ids), torch.cat(dists)


def rng_cap_rows(x: torch.Tensor, cand_ids: torch.Tensor, cand_d: torch.Tensor,
                 cfg: NSGStyleConfig) -> G.Graph:
    """RNG-prune expanded candidate rows (Alg. 3) and cap the out-degree at
    R. The prune is ``rng_prune`` over rows of C candidates."""
    keep = rng_prune_rows(x, cand_ids, cand_d, cfg.metric)
    pruned = G.sort_rows(G.Graph(
        neighbors=torch.where(keep, cand_ids, -1),
        dists=torch.where(keep, cand_d, float("inf")),
        flags=torch.zeros(cand_ids.shape, dtype=torch.uint8, device=cand_ids.device)))
    nbrs, dists = pruned.neighbors.clone(), pruned.dists.clone()
    nbrs[:, cfg.r:] = -1
    dists[:, cfg.r:] = float("inf")
    return G.Graph(nbrs, dists, pruned.flags)


def refine(x: torch.Tensor, knn_g: G.Graph, cfg: NSGStyleConfig, entry=None) -> G.Graph:
    """The stages after the K-NN graph: expand, prune and cap, reverse
    edges capped at R, connectivity repair (always through the sort merge,
    whatever ``cfg.merge``: it runs once, and nothing offers a dropped
    repair edge again). ``x`` is the corpus as built (decoded when coded)."""
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    with _tr.span("nsg_style/expand") as sp:
        cand_ids, cand_d = expand_candidates(x, knn_g, cfg.c, cfg.metric)
        if sp:
            _gs.sync(cand_ids)
            sp.set(pool=int(cand_ids.shape[1]))
    with _tr.span("nsg_style/prune") as sp, _ch.span_costs(sp, x.device):
        capped = rng_cap_rows(x, cand_ids, cand_d, cfg)
        if sp:
            _gs.sync(capped.neighbors)
            _gs.record_sweep(sp, capped, algo="nsg_style", phase="sweep")
    del cand_ids, cand_d
    with _tr.span("nsg_style/reverse") as sp:
        g = G.add_reverse_edges(capped, cfg.r, merge=cfg.merge, n_buckets=cfg.n_buckets)
        if sp:
            _gs.sync(g.neighbors)
            _gs.record_sweep(sp, g, algo="nsg_style", phase="reverse")
    if entry is None:
        from repro_torch.core.search import default_entry_point
        entry = default_entry_point(x, cfg.metric)
    with _tr.span("nsg_style/repair") as sp:
        g = ensure_reachable(x, g, entry, cfg.metric)
        if sp:
            _gs.sync(g.neighbors)
    return g


def build(x, cfg: NSGStyleConfig, generator: torch.Generator | None = None,
          entry=None, device: str | torch.device = "cuda", mesh=None) -> G.Graph:
    """NN-Descent (``cfg.knn``), then :func:`refine`. ``x`` and
    ``generator`` as in ``nn_descent.build``. ``cfg.quant`` int8/pq decodes
    the corpus once at entry; every stage runs over ``x_hat``. ``mesh``:
    the K-NN stage and the per-row stages run row-sharded, the repair on
    every rank (``core/shard.py``), as in ``rnn_descent.build``. With
    ``repro_torch.obs`` enabled the stages run under ``nsg_style/knn``,
    ``/expand``, ``/prune``, ``/reverse`` and ``/repair`` spans, the prune
    and the reverse pass with the per-sweep graph readouts; the graph is
    bit for bit the untraced one."""
    x = as_tensor(x, device, torch.float32)
    x, _ = prep_corpus(x, cfg.quant)
    if mesh is not None:
        from repro_torch.core import shard
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        return shard.build_nsg_style(x, cfg, generator, mesh, entry=entry)
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    with _tr.span("nsg_style/knn") as sp:
        knn_g = nnd.build(x, cfg.knn, generator)
        if sp:
            _gs.sync(knn_g.neighbors)
    return refine(x, knn_g, cfg, entry)
