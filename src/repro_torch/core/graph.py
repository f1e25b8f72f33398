"""Fixed-capacity adjacency graphs (port of ``repro.core.graph``).

A dense ``(n, M)`` adjacency with ``-1`` padding; every structural mutation
goes through one of two merge paths: ``merge="sort"``, the exact oracle
(global lexicographic sorts, emulated by successive stable sorts from the last
key to the first), and ``merge="bucketed"``, the default (staged
lexicographic-min scatter into per-row hashed buckets, then per-row sorts).

Distance keys: the reference's ``dist_key`` is uint32. The port carries an
order-preserving **int32** key instead (``b = bits(f)``; ``key = b`` if
``b >= 0`` else ``b ^ 0x7FFFFFFF``), since int32 supports ``>>`` and
``scatter_reduce`` everywhere. It converts exactly: ``u32 = key ^ 0x80000000``
(``repro_torch.convert``); the reference's empty-slot sentinel
``0xFFFFFFFF`` is ``INT32_MAX`` here.

Row invariant everywhere: valid entries first, ascending distance. Every sort
that can meet ties is stable, as ``jnp.argsort``/``jnp.sort`` are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distances as D

NEW = 1
OLD = 0

MERGE_MODES = ("sort", "bucketed")

INT32_MAX = 2**31 - 1
KEY_SENTINEL = INT32_MAX          # empty bucket slot
_SLOT_MULT = 2654435761           # Knuth; odd => bijective mod 2^k
_U32 = 0xFFFFFFFF


class Graph(NamedTuple):
    """neighbors: (n, M) int32 ids (-1 pad) | dists: (n, M) f32 (+inf pad)
    | flags: (n, M) uint8 (1 = "new")."""

    neighbors: torch.Tensor
    dists: torch.Tensor
    flags: torch.Tensor

    @property
    def n(self) -> int:
        return self.neighbors.shape[0]

    @property
    def capacity(self) -> int:
        return self.neighbors.shape[1]


def empty_graph(n: int, m: int, device: torch.device | str) -> Graph:
    return Graph(
        neighbors=torch.full((n, m), -1, dtype=torch.int32, device=device),
        dists=torch.full((n, m), float("inf"), dtype=torch.float32, device=device),
        flags=torch.zeros((n, m), dtype=torch.uint8, device=device),
    )


def _take(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, order)


def sort_rows(g: Graph) -> Graph:
    """Restore the row invariant (valid-first, ascending distance)."""
    order = torch.sort(g.dists, dim=1, stable=True).indices
    return Graph(_take(g.neighbors, order), _take(g.dists, order),
                 _take(g.flags, order))


def dedup_row_ids(ids: torch.Tensor) -> torch.Tensor:
    """Per-row id dedup: repeats become -1 (row order not preserved)."""
    s = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.where(dup, torch.full_like(s, -1), s)


def random_init_graph(x: torch.Tensor, s: int, capacity: int, metric: str = "l2",
                      generator: torch.Generator | None = None) -> Graph:
    """RandomGraph(S): ``s`` random out-neighbors per vertex (no self loops,
    per-row deduped), distances attached, rows sorted, all flags "new"."""
    n = x.shape[0]
    dev = x.device
    ids = torch.randint(0, n, (n, s), generator=generator, device=dev,
                        dtype=torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    ids = torch.where(ids == rows, (ids + 1) % n, ids)
    ids = dedup_row_ids(ids)
    dist = D.gather_dists(x, rows.expand(n, s).reshape(-1), ids.reshape(-1),
                          metric).reshape(n, s)
    pad = capacity - s
    g = Graph(
        neighbors=torch.nn.functional.pad(ids, (0, pad), value=-1),
        dists=torch.nn.functional.pad(dist, (0, pad), value=float("inf")),
        flags=torch.nn.functional.pad(
            torch.full((n, s), NEW, dtype=torch.uint8, device=dev), (0, pad),
            value=OLD),
    )
    return sort_rows(g)


def to_edge_list(g: Graph):
    """(src, dst, dist, flag) flat views; invalid slots have dst == -1."""
    n, m = g.neighbors.shape
    src = torch.arange(n, dtype=torch.int32, device=g.neighbors.device)[:, None] \
        .expand(n, m).reshape(-1)
    dst = g.neighbors.reshape(-1)
    src = torch.where(dst >= 0, src, torch.full_like(src, n))
    return src, dst, g.dists.reshape(-1), g.flags.reshape(-1)


# --------------------------------------------------------- sort-oracle path
def lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort`` semantics (last key primary): successive stable sorts
    from the last-listed (least significant, i.e. ``keys[0]``) key to the
    primary one."""
    order = torch.sort(keys[0], stable=True).indices
    for k in keys[1:]:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _segment_positions(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal keys (keys sorted)."""
    seg_start = torch.searchsorted(sorted_keys, sorted_keys, side="left")
    return torch.arange(sorted_keys.shape[0], device=sorted_keys.device) - seg_start


def dedup_edges(src, dst, dist, flag, priority, n: int):
    """Drop duplicate (src, dst) pairs keeping the lowest-priority copy;
    dropped / invalid entries become (n, -1, +inf, OLD)."""
    order = lexsort((priority, dst, src))
    s, d, w, f = src[order], dst[order], dist[order], flag[order]
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[1:] = (s[1:] == s[:-1]) & (d[1:] == d[:-1])
    invalid = (d < 0) | (s >= n) | dup | (s == d)
    return (
        torch.where(invalid, torch.full_like(s, n), s),
        torch.where(invalid, torch.full_like(d, -1), d),
        torch.where(invalid, torch.full_like(w, float("inf")), w),
        torch.where(invalid, torch.full_like(f, OLD), f),
    )


def cap_by_key(key, src, dst, dist, flag, cap: int, n: int):
    """Keep at most ``cap`` shortest edges per value of ``key``."""
    key = torch.where((dst < 0) | (key < 0) | (key >= n), torch.full_like(key, n), key)
    order = lexsort((dist, key))
    k, s, d, w, f = key[order], src[order], dst[order], dist[order], flag[order]
    pos = _segment_positions(k)
    drop = (pos >= cap) | (k >= n) | (d < 0)
    return (
        torch.where(drop, torch.full_like(s, n), s),
        torch.where(drop, torch.full_like(d, -1), d),
        torch.where(drop, torch.full_like(w, float("inf")), w),
        torch.where(drop, torch.full_like(f, OLD), f),
        torch.where(drop, torch.zeros_like(pos), pos),
        k,
    )


def edges_to_graph(src, dst, dist, flag, n: int, m: int, cap: int | None = None) -> Graph:
    """Scatter a flat edge list into (n, m) rows, keeping the ``cap``
    (default m) shortest edges per row."""
    s, d, w, f, pos, _ = cap_by_key(src, src, dst, dist, flag, min(cap or m, m), n)
    ok = (s < n) & (d >= 0)
    flat = torch.where(ok, s.long(), n) * m + pos       # row n = dropped
    g = empty_graph(n + 1, m, src.device)
    out = []
    for buf, val in zip(g, (d, w, f)):
        buf = buf.reshape(-1)
        buf[flat] = val.to(buf.dtype)
        out.append(buf.view(n + 1, m)[:n])
    return Graph(*out)


# ------------------------------------------------------- bucketed merge path
def dist_key(d: torch.Tensor) -> torch.Tensor:
    """Monotone, bijective f32 -> int32 sort key: d1 < d2 <=> key(d1) <
    key(d2), including negative distances and +/-inf."""
    b = d.float().contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ INT32_MAX)


def key_dist(k: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`dist_key`."""
    b = torch.where(k >= 0, k, k ^ INT32_MAX)
    return b.contiguous().view(torch.float32)


def default_buckets(cap: int) -> int:
    """Bucket width: next power of two >= max(2 * cap, 128)."""
    b = 128
    while b < 2 * cap:
        b *= 2
    return b


def _bucket_slots(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """id -> bucket slot (the reference's uint32 multiplicative hash, in
    int64 arithmetic: the low bits of the product are the same)."""
    if n_buckets <= 0 or n_buckets & (n_buckets - 1) != 0:
        raise ValueError(
            f"n_buckets={n_buckets} must be a power of two (the slot mask "
            "`h & (n_buckets - 1)` requires it)")
    return ((ids.long() * _SLOT_MULT) & (n_buckets - 1))


def bucket_scatter_tables(rows, ids, dist, flag, n: int, n_buckets: int,
                          prio: torch.Tensor | None = None):
    """Staged bucket tables ``(p, k, i, f)`` of shape (n, n_buckets): each
    (row, slot) holds the lexicographically-least (priority, key, id) among
    the candidates hashing there, and the max flag over candidates achieving
    it. Empty slots are (INT32_MAX, KEY_SENTINEL, INT32_MAX, 0). ``p`` is
    None when ``prio`` is None."""
    rows = rows.reshape(-1).long()
    ids = ids.reshape(-1).int()
    dist = dist.reshape(-1)
    flag = flag.reshape(-1)
    dev = ids.device
    valid = (ids >= 0) & (rows >= 0) & (rows < n) & (ids != rows) & ~torch.isnan(dist)
    slot = _bucket_slots(ids, n_buckets)
    key = dist_key(dist)
    size = (n + 1) * n_buckets            # row n collects the dropped entries
    flat_ok = rows * n_buckets + slot     # valid entries only

    def target(alive):
        return torch.where(alive, flat_ok, n * n_buckets)

    def winners(table, val, alive):
        table.scatter_reduce_(0, target(alive), val, reduce="amin")
        return alive & (val == table[torch.where(alive, flat_ok, 0)])

    alive = valid
    p_tab = None
    if prio is not None:
        prio = prio.reshape(-1).int()
        p_tab = torch.full((size,), INT32_MAX, dtype=torch.int32, device=dev)
        alive = winners(p_tab, prio, alive)
    k_tab = torch.full((size,), KEY_SENTINEL, dtype=torch.int32, device=dev)
    alive = winners(k_tab, key, alive)
    i_tab = torch.full((size,), INT32_MAX, dtype=torch.int32, device=dev)
    alive = winners(i_tab, ids, alive)
    # flags reduce in int32 (native atomics on every device), stored as uint8
    f_tab = torch.zeros((size,), dtype=torch.int32, device=dev)
    f_tab.scatter_reduce_(0, target(alive), flag.int(), reduce="amax")

    def view(t):
        return None if t is None else t.view(n + 1, n_buckets)[:n]

    return view(p_tab), view(k_tab), view(i_tab), view(f_tab).to(torch.uint8)


def decode_bucket_tables(k_tab, i_tab, f_tab):
    """Raw tables -> (ids, dist, flag); empty slots become (-1, +inf, OLD)."""
    empty = k_tab == KEY_SENTINEL
    return (
        torch.where(empty, torch.full_like(i_tab, -1), i_tab),
        torch.where(empty, torch.full(k_tab.shape, float("inf"), device=k_tab.device),
                    key_dist(k_tab)),
        torch.where(empty, torch.zeros_like(f_tab), f_tab),
    )


def bucket_scatter(rows, ids, dist, flag, n: int, n_buckets: int,
                   prio: torch.Tensor | None = None):
    """Scatter a flat edge list into per-row hashed buckets -> (ids, dist,
    flag), each (n, n_buckets); empty slots are (-1, +inf, OLD)."""
    _, k_tab, i_tab, f_tab = bucket_scatter_tables(rows, ids, dist, flag, n,
                                                   n_buckets, prio=prio)
    return decode_bucket_tables(k_tab, i_tab, f_tab)


def row_topk(ids, dist, flag, cap: int, width: int):
    """Per-row: keep the ``cap`` shortest valid entries, emitted into
    ``width`` slots under the row invariant."""
    if ids.shape[1] < width:
        pad = width - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        dist = torch.nn.functional.pad(dist, (0, pad), value=float("inf"))
        flag = torch.nn.functional.pad(flag, (0, pad))
    dist = torch.where(ids >= 0, dist, torch.full_like(dist, float("inf")))
    order = torch.sort(dist, dim=1, stable=True).indices[:, :width]
    ids, dist, flag = _take(ids, order), _take(dist, order), _take(flag, order)
    live = (torch.arange(width, device=ids.device)[None, :] < cap) & (ids >= 0) \
        & (dist < float("inf"))
    return (
        torch.where(live, ids, torch.full_like(ids, -1)),
        torch.where(live, dist, torch.full_like(dist, float("inf"))),
        torch.where(live, flag, torch.zeros_like(flag)),
    )


def merge_rows_with_buckets(g: Graph, b_ids, b_dist, b_flag, cap: int, width: int) -> Graph:
    """Merge each adjacency row with its candidate bucket: bucket entries
    whose id already is in the row are dropped (the row's copy wins and keeps
    its flag), then the ``cap`` shortest survivors fill ``width`` slots."""
    n, m = g.neighbors.shape
    if n >= 2**30:
        raise ValueError(f"n={n} too large for the int32 (id, is_bucket) packing")
    ids = torch.cat([g.neighbors, b_ids], dim=1)
    dist = torch.cat([g.dists, b_dist], dim=1)
    flag = torch.cat([g.flags, b_flag], dim=1)
    # id-dedup with row priority: sort by (id, is_bucket) packed into int32 —
    # the row copy's low bit is 0, so it sorts first and survives
    is_bucket = (torch.arange(ids.shape[1], device=ids.device) >= m).int()
    packed = torch.where(ids >= 0, ids * 2 + is_bucket[None, :],
                         torch.full_like(ids, INT32_MAX))
    order = torch.sort(packed, dim=1, stable=True).indices
    ids, dist, flag = _take(ids, order), _take(dist, order), _take(flag, order)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = (ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)
    ids = torch.where(dup, torch.full_like(ids, -1), ids)
    return Graph(*row_topk(ids, dist, flag, cap, width))


def _merge_candidate_edges_bucketed(g: Graph, cand_src, cand_dst, cand_dist,
                                    cap: int, n_buckets: int | None) -> Graph:
    n, m = g.neighbors.shape
    b = n_buckets or default_buckets(cap)
    new = torch.full(cand_dst.reshape(-1).shape, NEW, dtype=torch.uint8,
                     device=cand_dst.device)
    b_ids, b_dist, b_flag = bucket_scatter(cand_src, cand_dst, cand_dist, new, n, b)
    return merge_rows_with_buckets(g, b_ids, b_dist, b_flag, cap, m)


def _reverse_edge_list(g: Graph):
    """E ∪ reverse(E) as a flat (src, dst, dist, flag, prio) edge list;
    reversed copies are NEW with priority 1 (originals 0)."""
    n = g.n
    es, ed, ew, ef = to_edge_list(g)
    rs = torch.where(ed >= 0, ed, torch.full_like(ed, n))
    rd = torch.where((ed >= 0) & (es < n), es, torch.full_like(es, -1))
    return (torch.cat([es, rs]), torch.cat([ed, rd]), torch.cat([ew, ew]),
            torch.cat([ef, torch.full_like(ef, NEW)]),
            torch.cat([torch.zeros_like(es), torch.ones_like(rs)]))


def _add_reverse_edges_bucketed(g: Graph, r: int, n_buckets: int | None) -> Graph:
    n, m = g.neighbors.shape
    b = n_buckets or default_buckets(r)
    src, dst, dist, flag, prio = _reverse_edge_list(g)
    # in-degree cap: bucket per destination, the original copy wins
    in_ids, in_dist, in_flag = bucket_scatter(dst, src, dist, flag, n, b, prio=prio)
    wa = min(r, b)
    in_ids, in_dist, in_flag = row_topk(in_ids, in_dist, in_flag, r, wa)
    # surviving edges (u -> v): bucket row v holds in-neighbor u
    e_src = in_ids.reshape(-1)
    rows = torch.arange(n, dtype=torch.int32, device=e_src.device)[:, None] \
        .expand(n, wa).reshape(-1)
    e_dst = torch.where(e_src >= 0, rows, torch.full_like(rows, -1))
    # out-degree cap: bucket per source (input already deduped)
    out_ids, out_dist, out_flag = bucket_scatter(
        e_src, e_dst, in_dist.reshape(-1), in_flag.reshape(-1), n, b)
    return Graph(*row_topk(out_ids, out_dist, out_flag, min(r, m), m))


# ------------------------------------------------------------- public merges
def merge_candidate_edges(g: Graph, cand_src, cand_dst, cand_dist,
                          cap: int | None = None, merge: str = "sort",
                          n_buckets: int | None = None) -> Graph:
    """Insert candidate edges (flagged NEW) into ``g``'s rows; pre-existing
    (src, dst) duplicates win. Each row keeps its ``cap`` shortest edges."""
    if merge not in MERGE_MODES:
        raise ValueError(f"unknown merge mode {merge!r}: expected one of {MERGE_MODES}")
    n, m = g.neighbors.shape
    cap = m if cap is None else cap
    cand_src = cand_src.reshape(-1).int()
    cand_dst = cand_dst.reshape(-1).int()
    cand_dist = cand_dist.reshape(-1)
    if merge == "bucketed":
        return _merge_candidate_edges_bucketed(g, cand_src, cand_dst, cand_dist,
                                               cap, n_buckets)
    es, ed, ew, ef = to_edge_list(g)
    src = torch.cat([es, torch.where(cand_dst >= 0, cand_src, torch.full_like(cand_src, n))])
    dst = torch.cat([ed, cand_dst])
    dist = torch.cat([ew, cand_dist])
    flag = torch.cat([ef, torch.full(cand_dst.shape, NEW, dtype=torch.uint8,
                                     device=ef.device)])
    prio = torch.cat([torch.zeros_like(es), torch.ones_like(cand_src)])
    src, dst, dist, flag = dedup_edges(src, dst, dist, flag, prio, n)
    return edges_to_graph(src, dst, dist, flag, n, cap)


def add_reverse_edges(g: Graph, r: int, merge: str = "sort",
                      n_buckets: int | None = None) -> Graph:
    """Paper Algorithm 5: E <- E ∪ reverse(E) (new edges NEW), cap in-degree
    to the R shortest incoming edges per vertex, then out-degree likewise."""
    if merge not in MERGE_MODES:
        raise ValueError(f"unknown merge mode {merge!r}: expected one of {MERGE_MODES}")
    if merge == "bucketed":
        return _add_reverse_edges_bucketed(g, r, n_buckets)
    n, m = g.neighbors.shape
    src, dst, dist, flag, prio = _reverse_edge_list(g)
    src, dst, dist, flag = dedup_edges(src, dst, dist, flag, prio, n)
    src, dst, dist, flag, _, _ = cap_by_key(dst, src, dst, dist, flag, r, n)
    return edges_to_graph(src, dst, dist, flag, n, m, cap=r)


def out_degrees(g: Graph) -> torch.Tensor:
    return torch.sum(g.neighbors >= 0, dim=1)


def in_degrees(g: Graph) -> torch.Tensor:
    flat = g.neighbors.reshape(-1)
    return torch.bincount(flat[flat >= 0].long(), minlength=g.n).int()


def average_out_degree(g: Graph, k: int | None = None) -> torch.Tensor:
    """Average out-degree, optionally under a query-time top-K limit."""
    deg = out_degrees(g)
    if k is not None:
        deg = torch.clamp(deg, max=k)
    return deg.float().mean()
