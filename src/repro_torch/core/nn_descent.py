"""NN-Descent baseline (Dong et al., WWW'11; paper Algorithm 2), port of
``repro.core.nn_descent``.

Every iteration runs the local join: for every vertex u, every pair (v1, v2)
of u's neighbours becomes a candidate edge v1 -> v2 when at least one of the
pair is flagged "new"; each row then keeps its K nearest.

The join floods n·j² candidates (4.1e9 at n = 1M, j = K = 64), so the
bucketed merge never holds them whole. It walks the source rows in chunks
of at most ``JOIN_BUDGET`` candidates and scatters each chunk into one
accumulating table of packed int64 ``(key << 32) | id`` (``graph.dist_key``
order, then id). The join has no priority stage and flags every candidate
"new", so one ``amin`` over that packing is the staged (key, id, flag)
minimum of ``graph.bucket_scatter_tables``, and it accumulates across chunks.
The rows then merge with their buckets in row chunks. ``merge="sort"`` keeps
the reference's flat lists and global sorts (the oracle, for small n).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor
from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.quant import Quantization, prep_corpus

JOIN_BUDGET = 1 << 27     # candidates of one join chunk (about 6 GiB of temporaries)
INT64_MAX = 2**63 - 1     # an empty slot of the packed join table
_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NNDescentConfig:
    """Paper §5.1 settings: K=64, S=10, iters=10."""

    k: int = 64
    s: int = 10            # out-degree of the random initial graph
    iters: int = 10
    sample: int | None = None   # max joined neighbours per vertex (None = all K)
    metric: str = "l2"
    chunk: int = 256       # rows per block of join_candidates' flat lists
    merge: str = "bucketed"    # "bucketed" (scatter) | "sort" (oracle)
    n_buckets: int | None = None
    quant: Quantization = Quantization()  # int8/pq: build over the decoded corpus

    def __post_init__(self):
        if self.merge not in G.MERGE_MODES:
            raise ValueError(
                f"unknown merge mode {self.merge!r}: expected one of "
                f"{G.MERGE_MODES}")
        if not isinstance(self.quant, Quantization):
            raise ValueError(
                f"quant must be a repro_torch.quant.Quantization, got "
                f"{type(self.quant).__name__}")


def random_init(x: torch.Tensor, cfg: NNDescentConfig,
                generator: torch.Generator | None = None) -> G.Graph:
    """RandomGraph(S) with capacity K."""
    return G.random_init_graph(x, cfg.s, cfg.k, cfg.metric, generator)


def _active(cid: torch.Tensor, cflag: torch.Tensor, pair: torch.Tensor) -> torch.Tensor:
    """(C, j, j) join pairs (a, b): both valid, a != b, at least one "new"
    (the reference's ``active``)."""
    valid = cid >= 0
    new = cflag == G.NEW
    j = cid.shape[1]
    return ((new[:, :, None] | new[:, None, :]) & valid[:, :, None] & valid[:, None, :]
            & ~torch.eye(j, dtype=torch.bool, device=cid.device)[None])


def join_candidates(x: torch.Tensor, ids: torch.Tensor, flags: torch.Tensor,
                    cfg: NNDescentConfig):
    """The reference's flat (src, dst, dist) lists of the local join over
    ``ids``/``flags`` (already cut to the join width j), in blocks of
    ``cfg.chunk`` rows; padding rows and inactive pairs are (-1, -1, +inf)."""
    n_rows, j = ids.shape
    chunk = max(1, min(cfg.chunk, n_rows))
    pad = (-n_rows) % chunk
    ids = torch.nn.functional.pad(ids, (0, 0, 0, pad), value=-1)
    flags = torch.nn.functional.pad(flags, (0, 0, 0, pad), value=G.OLD)
    src, dst, dist = [], [], []
    for s in range(0, ids.shape[0], chunk):
        cid, cflag = ids[s:s + chunk], flags[s:s + chunk]
        pair = D.batched_gram(x[cid.clamp(min=0).long()], cfg.metric)
        active = _active(cid, cflag, pair)
        src.append(torch.where(active, cid[:, :, None], -1).reshape(-1))
        dst.append(torch.where(active, cid[:, None, :], -1).reshape(-1))
        dist.append(torch.where(active, pair, float("inf")).reshape(-1))
    return torch.cat(src), torch.cat(dst), torch.cat(dist)


def default_join_buckets(cfg: NNDescentConfig, capacity: int) -> int:
    """Bucket width of the join: it floods ~j² candidates a row, so the
    buckets scale with j², clamped at 2048."""
    if cfg.n_buckets is not None:
        return cfg.n_buckets
    j = min(cfg.sample or capacity, capacity)
    return min(G.default_buckets(j * j), 2048)


def join_table(x: torch.Tensor, ids: torch.Tensor, flags: torch.Tensor,
               cfg: NNDescentConfig, n_buckets: int, lo: int = 0,
               n_rows: int | None = None) -> torch.Tensor:
    """The local join over ``ids``/``flags`` (n, j) scattered into packed
    buckets: an (n_rows, n_buckets) int64 table of the destination rows
    [lo, lo + n_rows) (default: rows [0, n), the source rows' own), each
    slot holding the least ``(dist_key << 32) | id`` among the candidates of
    its row hashing there, ``INT64_MAX`` if none: the block restriction of
    the whole table (the sharded join, ``core/shard.py``). Source rows go in
    chunks of at most ``JOIN_BUDGET`` candidates; only the active pairs of a
    chunk are formed."""
    n, j = ids.shape
    restrict = n_rows is not None
    n_rows = n if n_rows is None else n_rows
    table = torch.full((n_rows * n_buckets,), INT64_MAX, dtype=torch.int64, device=ids.device)
    rows = max(1, JOIN_BUDGET // max(1, j * j))
    for s in range(0, n, rows):
        cid, cflag = ids[s:s + rows], flags[s:s + rows]
        pair = D.batched_gram(x[cid.clamp(min=0).long()], cfg.metric)
        # what the bucket scatter drops: self loops and NaN distances
        active = _active(cid, cflag, pair) & ~torch.isnan(pair) \
            & (cid[:, :, None] != cid[:, None, :])
        if restrict:     # destination row (the pair's first id) in the block
            active &= ((cid >= lo) & (cid < lo + n_rows))[:, :, None]
        f = active.view(-1).nonzero().squeeze(1)
        del active
        flat = cid.reshape(-1)
        src = flat[f // j].long() - lo
        dst = flat[f // (j * j) * j + f % j]
        key = G.dist_key(pair.view(-1)[f])
        del pair, f
        table.scatter_reduce_(0, src * n_buckets + G._bucket_slots(dst, n_buckets),
                              (key.long() << 32) | dst.long(), reduce="amin")
    return table.view(n_rows, n_buckets)


def merge_rows_with_table(g: G.Graph, table: torch.Tensor, cap: int) -> G.Graph:
    """``graph.merge_rows_with_buckets`` of rows holding distinct ids (the
    graph invariant) with their packed buckets, bit for bit: a bucket entry
    whose id is in its row is dropped (the row copy wins), then the ``cap``
    nearest live entries, ties toward the lower id, fill the row's width.
    The row dedup reads the one slot a row id hashes to, and the selection
    is a top-k of ``(dist_key << 32) | id`` (-0.0 keyed as +0.0, as a float
    sort sees it), so no row is sorted whole."""
    r, m = g.neighbors.shape
    nb = table.shape[1]
    empty = table == INT64_MAX
    b_ids = torch.where(empty, -1, (table & _LOW32).int())
    b_dist = torch.where(empty, float("inf"), G.key_dist((table >> 32).int()))
    slot = G._bucket_slots(g.neighbors.clamp(min=0), nb)
    hit = (torch.gather(b_ids, 1, slot) == g.neighbors) & (g.neighbors >= 0)
    dup = torch.zeros((r, nb), dtype=torch.int32, device=table.device) \
        .scatter_add_(1, slot, hit.int()) > 0
    b_ids = torch.where(dup, -1, b_ids)
    ids = torch.cat([g.neighbors, b_ids], dim=1)
    dist = torch.cat([g.dists, b_dist], dim=1)
    flag = torch.cat([g.flags, (b_ids >= 0).to(torch.uint8) * G.NEW], dim=1)
    live = (ids >= 0) & (dist < float("inf"))
    skey = torch.where(live, (G.dist_key(dist + 0.0).long() << 32) | ids.long(), INT64_MAX)
    order = torch.topk(skey, m, dim=1, largest=False, sorted=True).indices
    ids, dist, flag = (torch.gather(t, 1, order) for t in (ids, dist, flag))
    live = torch.gather(live, 1, order) & (torch.arange(m, device=ids.device) < cap)
    return G.Graph(torch.where(live, ids, -1), torch.where(live, dist, float("inf")),
                   torch.where(live, flag, 0))


def join_and_update(x: torch.Tensor, g: G.Graph, cfg: NNDescentConfig) -> G.Graph:
    """One NN-Descent iteration: local join (Alg. 2) + top-K merge. Every
    joined vertex becomes "old" before the candidates land (Alg. 2 L7).
    The bucketed merge works in chunks of ``JOIN_BUDGET`` candidates (the
    join) or row entries (the row merge)."""
    m = g.neighbors.shape[1]
    j = min(cfg.sample or m, m)          # join width: rows sorted, so the nearest j
    aged = G.Graph(g.neighbors, g.dists, torch.zeros_like(g.flags))
    nb = default_join_buckets(cfg, m)
    if cfg.merge == "sort":
        src, dst, dist = join_candidates(x, g.neighbors[:, :j], g.flags[:, :j], cfg)
        return G.merge_candidate_edges(aged, src, dst, dist, cap=cfg.k, merge="sort",
                                       n_buckets=nb)
    table = join_table(x, g.neighbors[:, :j].contiguous(), g.flags[:, :j].contiguous(),
                       cfg, nb)
    return merge_table_rows(aged, table, cfg.k)


def merge_table_rows(g: G.Graph, table: torch.Tensor, cap: int) -> G.Graph:
    """:func:`merge_rows_with_table` in chunks of ``JOIN_BUDGET`` row
    entries."""
    n, m = g.neighbors.shape
    out = G.empty_graph(n, m, g.neighbors.device)
    rows = max(1, JOIN_BUDGET // (m + table.shape[1]))
    for s in range(0, n, rows):
        part = merge_rows_with_table(G.Graph(*(t[s:s + rows] for t in g)),
                                     table[s:s + rows], cap)
        for buf, val in zip(out, part):
            buf[s:s + rows] = val
    return out


def build(x, cfg: NNDescentConfig, generator: torch.Generator | None = None,
          device: str | torch.device = "cuda", mesh=None) -> G.Graph:
    """NN-Descent: RandomGraph(S), then ``cfg.iters`` join-and-update
    iterations. ``x`` (n, d) float32: a tensor runs on its own device; numpy
    input is placed on ``device``. ``generator`` (on x's device) draws the
    random initial graph; None seeds one with 0. ``cfg.quant`` int8/pq
    descends over the decoded corpus. ``mesh``: row-sharded over the mesh's
    ranks (``core/shard.py``), as in ``rnn_descent.build``. With
    ``repro_torch.obs`` enabled each iteration runs under an
    ``nn_descent/iter`` span with the readouts of ``rnn_descent.build``'s
    sweeps; the graph is bit for bit the untraced one."""
    x = as_tensor(x, device, torch.float32)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    x, _ = prep_corpus(x, cfg.quant)
    if mesh is not None:
        from repro_torch.core import shard
        return shard.build_nn_descent(x, cfg, generator, mesh)
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    g = random_init(x, cfg, generator)
    prev_live = None
    for it in range(cfg.iters):
        with _tr.span("nn_descent/iter") as sp, _ch.span_costs(sp, x.device):
            g = join_and_update(x, g, cfg)
            if sp:
                _gs.sync(g.neighbors)
                prev_live = _gs.record_sweep(
                    sp, g, algo="nn_descent", phase="sweep",
                    prev_live=prev_live, iter=it)
    return g


def build_jit(x, cfg: NNDescentConfig, generator: torch.Generator | None = None) -> G.Graph:
    """The reference's name for the whole build as one compiled program
    (``lax.scan`` over the iterations). The port has no jit: this is
    :func:`build`, the same graph."""
    return build(x, cfg, generator)
