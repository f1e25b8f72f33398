"""Row-sharded index construction over ranks (port of ``repro.core.shard``).

Graph adjacency rows partition over the mesh axes the logical ``"rows"``
axis resolves to (``distributed/sharding.RULES``: ``"data"``, joined by
``"pod"``); the corpus ``x`` is replicated. The reference's ``shard_map``
becomes SPMD ranks: every rank calls the same function on its own block of
rows, ``[me * n_pad / D, (me + 1) * n_pad / D)`` of the graph padded to
``n_pad`` rows (:func:`local_rows`), and all per-row work (the fused RNG
prune, NN-Descent's local join, NSG's expansion, row sorts, degree caps)
runs rank-locally with no communication.

The only cross-rank traffic is candidate routing: a rank's rows emit
candidate edges whose *destination* rows live on other ranks (RNN-Descent's
replacement edges (w -> v) land in row w; reverse edges in the reversed
source's row). The bucketed merge makes that exchange a min-reduction, and
:func:`exchange_scatter` runs it destination-bucketed: on ring hop j every
rank scatters its candidates into only the (n_pad/D, B) table block owned by
index (me + j) % D, ships exactly that block (``comm.ppermute``) and folds
the arriving one into its accumulator with
``graph.combine_bucket_tables_pair``, so no rank ever holds a full-height
table. Each rank ends with the combined block of its own rows.

Exactness: each (row, slot) bucket entry is the lexicographic minimum over
the candidates hashing there, and a minimum over any partition of the
candidates combines to the global one, so every sharded build equals the
single-device build bit for bit (ids, distances, flags), for every builder
and metric. A blockwise scatter with shifted rows and a block-local height
is the block restriction of the full-height scatter (out-of-block rows
fail the range guard of ``bucket_scatter_tables``), and the pairwise fold
is associative and commutative.

Wire bytes a rank puts on the ring, per exchange: (D - 1) blocks of
(n_pad/D) x B slots at 9 bytes a slot (int32 key, int32 id, uint8 flag)
for a sweep's merge, 13 for the priority-staged in-degree pass of a reverse
step, 9 for its out-degree pass (22 together); NN-Descent ships the port's
packed int64 join table, 8 bytes a slot (:func:`_exchange_attrs`).

``n`` that does not divide by D: rows pad with empty adjacency (ids -1).
Padded rows emit no candidates and no real candidate targets them (every
id is < n), so the padding is inert and cut on exit.
"""
from __future__ import annotations

import torch

from repro_torch.core import graph as G
from repro_torch.distributed import comm as C
from repro_torch.distributed import sharding as SH

ROWS = "rows"  # logical axis name for graph adjacency rows (RULES)


def row_axes(mesh) -> tuple[str, ...]:
    """Physical mesh axes graph rows shard over (empty = replicated)."""
    return SH.mesh_axes(mesh, ROWS)


def n_shards(mesh) -> int:
    return SH.axis_count(mesh, ROWS)


def _check_mesh(mesh, merge: str) -> None:
    if merge != "bucketed":
        raise ValueError(
            f"sharded builds require merge='bucketed' (got {merge!r}): the "
            "cross-shard exchange is a min-reduction over bucket tables; the "
            "'sort' oracle is a global lexsort with no shard-local form")
    if not row_axes(mesh):
        raise ValueError(
            f"mesh axes {mesh.axis_names} give the logical 'rows' axis "
            "nothing to shard over: see RULES in distributed/sharding.py")


def _padded(n: int, d: int) -> int:
    return -(-n // d) * d


def pad_rows(g: G.Graph, n_pad: int) -> G.Graph:
    """Append empty (inert) adjacency rows up to ``n_pad``."""
    pad = n_pad - g.n
    if pad == 0:
        return g
    f = torch.nn.functional.pad
    return G.Graph(f(g.neighbors, (0, 0, 0, pad), value=-1),
                   f(g.dists, (0, 0, 0, pad), value=float("inf")),
                   f(g.flags, (0, 0, 0, pad), value=G.OLD))


def block_range(n_pad: int, mesh) -> tuple[int, int]:
    """(lo, rows) of this rank's block of an ``n_pad``-row table."""
    d = n_shards(mesh)
    n_blk = n_pad // d
    return C.axis_index(mesh, row_axes(mesh)) * n_blk, n_blk


def local_rows(g: G.Graph, mesh) -> G.Graph:
    """This rank's block of ``g`` padded to a multiple of the shard count."""
    gp = pad_rows(g, _padded(g.n, n_shards(mesh)))
    lo, n_blk = block_range(gp.n, mesh)
    return G.Graph(*(t[lo:lo + n_blk].contiguous() for t in gp))


def gather_rows(g_local: G.Graph, n: int, mesh) -> G.Graph:
    """The whole graph on every rank from the ranks' blocks (one
    ``all_gather`` of the three fields packed), padding cut."""
    axes = row_axes(mesh)
    if C.axis_size(mesh, axes) == 1:
        return G.Graph(*(t[:n] for t in g_local))
    buf = C.all_gather(C._pack(g_local)[None], mesh, axes)
    parts = [C._unpack(row, g_local) for row in buf]
    return G.Graph(*(torch.cat([p[i] for p in parts])[:n] for i in range(3)))


def _initial_graph(draw, init: G.Graph | None, n: int, m: int, device, mesh) -> G.Graph:
    """RandomGraph(S), the same on every rank: ``draw()`` runs on index 0 of
    the rows axes and the graph is broadcast (one rank at a time holds the
    draw's transients), so it is the single-device draw from that rank's
    generator. A caller's ``init`` is checked equal on every rank instead."""
    if init is not None:
        _check_replicated(init, mesh)
        return init
    axes = row_axes(mesh)
    if C.axis_size(mesh, axes) == 1:
        return draw()
    g = draw() if C.axis_index(mesh, axes) == 0 else G.empty_graph(n, m, device)
    got = C._unpack(C.broadcast(C._pack(g), mesh, axes), g)
    return G.Graph(*got)


def _check_replicated(g: G.Graph, mesh) -> None:
    """The ranks hold the same graph (RandomGraph(S) drawn on each): two
    order-sensitive checksums compared by min and max over the ranks."""
    axes = row_axes(mesh)
    w = torch.arange(1, g.neighbors.numel() + 1, device=g.neighbors.device).view_as(g.neighbors)
    h = torch.stack([(g.neighbors.long() * w).sum(),
                     (G.dist_key(g.dists).long() * w + g.flags.long()).sum()])
    if not torch.equal(C.pmin(h, mesh, axes), C.pmax(h, mesh, axes)):
        raise RuntimeError("the ranks' initial graphs differ: RandomGraph(S) must be "
                           "drawn from the same generator state on every rank")


def exchange_bucket_tables(mesh, tabs):
    """Reduce-scatter-min of full-height partial bucket tables ``(p, k, i,
    f)``, each (n_pad, B) (p may be None): an ``all_to_all`` hands each rank
    every rank's partial of its block, folded by
    ``graph.combine_bucket_tables``. Returns the (n_pad/D, B) tables of
    this rank's rows: equal to :func:`exchange_scatter`'s, through one
    collective and a full-height transient."""
    axes = row_axes(mesh)
    d = C.axis_size(mesh, axes)

    def rs(t):
        if t is None:
            return None
        return C.all_to_all(t.reshape(d, t.shape[0] // d, t.shape[1]), mesh, axes)

    return G.combine_bucket_tables(*(rs(t) for t in tabs))


def exchange_scatter(mesh, n_pad: int, scatter_block, fold=G.combine_bucket_tables_pair):
    """Destination-bucketed reduce-scatter-min of bucket tables.

    ``scatter_block(lo, n_blk)`` scatters this rank's candidates into the
    (n_blk, B) partial tables of destination rows [lo, lo + n_blk): the
    block restriction of the full-height scatter. Ring exchange: on hop j
    each rank computes the block of index (me + j) % D, ships it with
    ``comm.ppermute`` and folds the arriving block into its accumulator
    (``fold``, the pairwise staged minimum). Hop 0 is the rank's own block.
    Returns the combined (n_pad/D, B) tables of this rank's rows. The comm
    layer addresses ranks by their index over all of ``axes``, so the ring
    also runs when rows shard over several axes (the reference takes
    :func:`exchange_bucket_tables` there: ``lax.ppermute`` takes one axis)."""
    axes = row_axes(mesh)
    d = C.axis_size(mesh, axes)
    if d == 1:
        return scatter_block(0, n_pad)
    lo, n_blk = block_range(n_pad, mesh)
    me = lo // n_blk
    acc = scatter_block(lo, n_blk)
    for j in range(1, d):
        blk = scatter_block((me + j) % d * n_blk, n_blk)
        acc = fold(acc, C.ppermute(blk, mesh, axes, j))
    return acc


def block_scatter(cand_src, cand_dst, cand_dist, flags, n_buckets: int, prio=None):
    """``scatter_block(lo, n_blk)`` of a flat candidate list: rows
    ``cand_src``, ids ``cand_dst`` (the staged tables of
    ``graph.bucket_scatter_tables``, block-local rows, self loops judged
    against the global row id)."""
    def scatter_block(lo, n_blk):
        rid = torch.arange(lo, lo + n_blk, dtype=torch.int32, device=cand_dst.device)
        return G.bucket_scatter_tables(cand_src.long() - lo, cand_dst, cand_dist, flags,
                                       n_blk, n_buckets, prio=prio, row_ids=rid)
    return scatter_block


def _merge_candidates_shard(g_local: G.Graph, cand_src, cand_dst, cand_dist, cap: int,
                            b: int, mesh) -> G.Graph:
    """Rank-local half of ``merge_candidate_edges(merge="bucketed")``:
    scatter this rank's candidates one destination block at a time,
    ring-exchange the blocks, merge the combined block into the local
    rows."""
    cand_dst = cand_dst.reshape(-1).int()
    flags = torch.full(cand_dst.shape, G.NEW, dtype=torch.uint8, device=cand_dst.device)
    n_pad = g_local.n * n_shards(mesh)
    _, kt, it, ft = exchange_scatter(
        mesh, n_pad, block_scatter(cand_src.reshape(-1), cand_dst, cand_dist.reshape(-1),
                                   flags, b))
    b_ids, b_dist, b_flag = G.decode_bucket_tables(kt, it, ft)
    return G.merge_rows_with_buckets(g_local, b_ids, b_dist, b_flag, cap,
                                     g_local.neighbors.shape[1])


def merge_candidate_edges(g_local: G.Graph, cand_src, cand_dst, cand_dist, mesh,
                          cap: int | None = None, n_buckets: int | None = None) -> G.Graph:
    """Sharded ``graph.merge_candidate_edges(merge="bucketed")``: each rank
    passes its block of rows and its own candidates (any partition of the
    candidate list, or the whole list on every rank: the fold is an
    idempotent minimum) and gets its block of the merged graph back."""
    cap = g_local.capacity if cap is None else cap
    b = n_buckets or G.default_buckets(cap)
    return _merge_candidates_shard(g_local, cand_src, cand_dst, cand_dist, cap, b, mesh)


# ------------------------------------------------------------- RNN-Descent
def rnn_update_neighbors(x, g_local: G.Graph, cfg, mesh, qx=None) -> G.Graph:
    """Sharded paper Algorithm 4 sweep: ``rnn_descent.update_neighbors``
    on this rank's block of rows (``x`` replicated, in the gram dtype;
    ``qx`` the replicated int8 codes when the prune runs over them)."""
    from repro_torch.core import rnn_descent as rd
    keep, red_w, red_d = rd.prune_rows(x, g_local.neighbors, g_local.dists,
                                       g_local.flags, cfg, qx=qx)
    inf = torch.tensor(float("inf"), device=g_local.dists.device)
    pruned = G.sort_rows(G.Graph(
        neighbors=torch.where(keep, g_local.neighbors, -1),
        dists=torch.where(keep, g_local.dists, inf),
        flags=torch.zeros_like(g_local.flags)))
    # replacement edges (w -> v): destination row w lives on any rank
    cand_dst = torch.where(red_w >= 0, g_local.neighbors, -1)
    m = g_local.capacity
    return _merge_candidates_shard(pruned, red_w, cand_dst, red_d, m,
                                   cfg.n_buckets or G.default_buckets(m), mesh)


def add_reverse_edges(g_local: G.Graph, r: int, mesh, n_buckets: int | None = None) -> G.Graph:
    """Sharded paper Algorithm 5: ``graph.add_reverse_edges(merge=
    "bucketed")`` on this rank's block. Both degree caps run as bucket
    exchanges: the in-degree cap groups E ∪ reverse(E) by destination row,
    the out-degree cap regroups the survivors by source row."""
    n_loc, m = g_local.neighbors.shape
    b = n_buckets or G.default_buckets(r)
    wa = min(r, b)
    n_pad = n_loc * n_shards(mesh)
    lo, _ = block_range(n_pad, mesh)
    dev = g_local.neighbors.device
    rid = torch.arange(lo, lo + n_loc, dtype=torch.int32, device=dev)
    src = rid[:, None].expand(n_loc, m).reshape(-1)
    dst = g_local.neighbors.reshape(-1)
    dist = g_local.dists.reshape(-1)
    flag = g_local.flags.reshape(-1)
    # E ∪ reverse(E) grouped by destination row: forward (u -> v) in row v
    # (priority 0, its flag), the reversed copy (v -> u) in row u (priority
    # 1, NEW), so a pre-existing copy of a mutual edge wins
    rows_cat = torch.cat([dst, torch.where(dst >= 0, src, -1)])
    ids_cat = torch.cat([src, dst])
    prio_cat = torch.cat([torch.zeros_like(src), torch.ones_like(src)])
    scat_in = block_scatter(rows_cat, ids_cat, torch.cat([dist, dist]),
                            torch.cat([flag, torch.full_like(flag, G.NEW)]), b, prio=prio_cat)
    _, kt, it, ft = exchange_scatter(mesh, n_pad, scat_in)
    in_ids, in_dist, in_flag = G.row_topk(*G.decode_bucket_tables(kt, it, ft), r, wa)
    # surviving edges (u -> v), regrouped by source for the out-degree cap
    e_src = in_ids.reshape(-1)
    e_dst = torch.where(e_src >= 0, rid[:, None].expand(n_loc, wa).reshape(-1), -1)
    scat_out = block_scatter(e_src, e_dst, in_dist.reshape(-1), in_flag.reshape(-1), b)
    _, kt, it, ft = exchange_scatter(mesh, n_pad, scat_out)
    return G.Graph(*G.row_topk(*G.decode_bucket_tables(kt, it, ft), min(r, m), m))


def _exchange_attrs(n: int, mesh, buckets: int, slot_bytes: int) -> dict:
    """The closed form of one exchange on this mesh: D - 1 ring hops, each
    shipping one (n_pad/D, B) block at ``slot_bytes`` a slot (9 for a sweep,
    22 for a reverse pass's two exchanges, 8 for NN-Descent's packed
    table); ``exchange_bytes_per_device`` is what one rank puts on the
    wire."""
    d = n_shards(mesh)
    n_pad = _padded(n, d)
    wire = slot_bytes * buckets * n_pad * (d - 1) // d if d > 1 else 0
    return {
        "exchange_hops": d - 1,
        "exchange_block_rows": n_pad // d,
        "exchange_buckets": buckets,
        "exchange_bytes_per_device": wire,
        "devices": d,
    }


def build_rnn_descent(x, cfg, generator, mesh, qx=None, init: G.Graph | None = None) -> G.Graph:
    """Sharded paper Algorithm 6 (the ``rnn_descent.build(mesh=)`` entry
    point). ``x``/``qx`` arrive prepared by ``rnn_descent.build`` (under a
    coded ``cfg.quant`` x is the decoded corpus). RandomGraph(S) is drawn
    from ``generator`` on the first rank and broadcast, or ``init`` is the
    initial graph (the same on every rank: checked); the sweeps run
    row-sharded. Returns the whole graph on every rank.

    Observability: the spans of ``rnn_descent.build`` on every rank, their
    graph readouts taken over the rank's own rows (no collective is added),
    with the ring exchange's hop count and closed-form wire bytes
    (:func:`_exchange_attrs`)."""
    from repro_torch.core import rnn_descent as rd
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    _check_mesh(mesh, cfg.merge)
    n = x.shape[0]
    g = _initial_graph(lambda: rd.random_init(x, cfg, generator), init, n, cfg.capacity,
                       x.device, mesh)
    g = local_rows(g, mesh)
    xg = rd.gram_input(x, cfg)
    prev_live, sweep = None, 0
    for t1 in range(cfg.t1):
        for _ in range(cfg.t2):
            with _tr.span("rnn_descent/sweep") as sp, _ch.span_costs(sp, x.device):
                g = rnn_update_neighbors(xg, g, cfg, mesh, qx=qx)
                if sp:
                    _gs.sync(g.neighbors)
                    prev_live = _gs.record_sweep(
                        sp, g, algo="rnn_descent", phase="sweep", prev_live=prev_live,
                        sweep=sweep, t1=t1, **_exchange_attrs(
                            n, mesh, cfg.n_buckets or G.default_buckets(cfg.capacity), 9))
            sweep += 1
        if t1 != cfg.t1 - 1:
            with _tr.span("rnn_descent/reverse") as sp, _ch.span_costs(sp, x.device):
                g = add_reverse_edges(g, cfg.r, mesh, cfg.n_buckets)
                if sp:
                    _gs.sync(g.neighbors)
                    prev_live = _gs.record_sweep(
                        sp, g, algo="rnn_descent", phase="reverse", t1=t1,
                        **_exchange_attrs(n, mesh, cfg.n_buckets or G.default_buckets(cfg.r),
                                          22))
    return gather_rows(g, n, mesh)


# -------------------------------------------------------------- NN-Descent
def nn_join_and_update(x, g_local: G.Graph, cfg, mesh) -> G.Graph:
    """Sharded NN-Descent iteration: ``nn_descent.join_and_update`` on this
    rank's block. Each hop joins the local rows into the packed int64 table
    of one destination block (``nn_descent.join_table(lo=, n_rows=)``; the
    join's arithmetic is redone per hop, so no rank holds a full-height
    table), the blocks fold by elementwise minimum (the staged fold of a
    table with no priority stage whose flags are all NEW), and the rows
    merge with their block."""
    from repro_torch.core import nn_descent as nnd
    m = g_local.capacity
    j = min(cfg.sample or m, m)
    nb = nnd.default_join_buckets(cfg, m)
    ids = g_local.neighbors[:, :j].contiguous()
    flags = g_local.flags[:, :j].contiguous()

    def scatter_block(lo, n_blk):
        return nnd.join_table(x, ids, flags, cfg, nb, lo=lo, n_rows=n_blk)

    table = exchange_scatter(mesh, g_local.n * n_shards(mesh), scatter_block,
                             fold=torch.minimum)
    aged = G.Graph(g_local.neighbors, g_local.dists, torch.zeros_like(g_local.flags))
    return nnd.merge_table_rows(aged, table, cfg.k)


def build_nn_descent(x, cfg, generator, mesh, init: G.Graph | None = None) -> G.Graph:
    """Sharded NN-Descent (``nn_descent.build(mesh=)``); ``init`` as in
    :func:`build_rnn_descent`. Returns the whole graph on every rank."""
    from repro_torch.core import nn_descent as nnd
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    _check_mesh(mesh, cfg.merge)
    n = x.shape[0]
    g = _initial_graph(lambda: nnd.random_init(x, cfg, generator), init, n, cfg.k,
                       x.device, mesh)
    g = local_rows(g, mesh)
    prev_live = None
    for it in range(cfg.iters):
        with _tr.span("nn_descent/iter") as sp, _ch.span_costs(sp, x.device):
            g = nn_join_and_update(x, g, cfg, mesh)
            if sp:
                _gs.sync(g.neighbors)
                prev_live = _gs.record_sweep(
                    sp, g, algo="nn_descent", phase="sweep", prev_live=prev_live, iter=it,
                    **_exchange_attrs(n, mesh, nnd.default_join_buckets(cfg, g.capacity), 8))
    return gather_rows(g, n, mesh)


# ---------------------------------------------------------------- NSG-style
def _nsg_expand_cap(x, knn: G.Graph, cfg, mesh) -> G.Graph:
    """Sharded NSG candidate expansion, RNG prune and out-degree cap of this
    rank's block (the K-NN graph replicated: the 2-hop pools read any
    row); padded rows expand to empty ones."""
    from repro_torch.core import nsg_style
    n = x.shape[0]
    lo, n_blk = block_range(_padded(n, n_shards(mesh)), mesh)
    rows = torch.arange(lo, lo + n_blk, dtype=torch.int32, device=x.device)
    rows = torch.where(rows < n, rows, -1)
    cand_ids, cand_d = nsg_style.expand_candidates(x, knn, cfg.c, cfg.metric, rows=rows)
    return nsg_style.rng_cap_rows(x, cand_ids, cand_d, cfg)


def build_nsg_style(x, cfg, generator, mesh, entry=None, init: G.Graph | None = None) -> G.Graph:
    """Sharded NSG-style refinement (``nsg_style.build(mesh=)``). The K-NN
    stage and both per-row stages run row-sharded; the connectivity repair
    runs replicated on the whole graph (a one-shot BFS through the sort
    merge, with no rank-local form), the single-device computation on
    every rank. ``init``: the K-NN stage's initial graph."""
    from repro_torch.core import nsg_style
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    _check_mesh(mesh, cfg.merge)
    if cfg.knn.merge != "bucketed":
        raise ValueError(
            f"sharded nsg-style requires knn.merge='bucketed', got {cfg.knn.merge!r}")
    with _tr.span("nsg_style/knn") as sp:
        knn = build_nn_descent(x, cfg.knn, generator, mesh, init=init)
        if sp:
            _gs.sync(knn.neighbors)
    with _tr.span("nsg_style/prune") as sp, _ch.span_costs(sp, x.device):
        capped = _nsg_expand_cap(x, knn, cfg, mesh)
        if sp:
            _gs.sync(capped.neighbors)
            _gs.record_sweep(sp, capped, algo="nsg_style", phase="sweep")
    del knn
    with _tr.span("nsg_style/reverse") as sp:
        g = add_reverse_edges(capped, cfg.r, mesh, cfg.n_buckets)
        if sp:
            _gs.sync(g.neighbors)
            _gs.record_sweep(sp, g, algo="nsg_style", phase="reverse", **_exchange_attrs(
                x.shape[0], mesh, cfg.n_buckets or G.default_buckets(cfg.r), 22))
    # replicated connectivity repair: the single-device computation on every rank
    with _tr.span("nsg_style/repair") as sp:
        g = gather_rows(g, x.shape[0], mesh)
        if entry is None:
            from repro_torch.core.search import default_entry_point
            entry = default_entry_point(x, cfg.metric)
        g = nsg_style.ensure_reachable(x, g, entry, cfg.metric)
        if sp:
            _gs.sync(g.neighbors)
    return g
