"""Graph traversal search (paper Algorithm 1 + Eq. 4), port of
``repro.core.search``.

Best-first beam search with beam width L over fixed-shape state: a (B, L)
beam (ids / dists / expanded) plus per-query visited bookkeeping. Eq. 4
truncates each expanded vertex's adjacency to its first K entries (rows are
distance-sorted). The gather+score step is the ``beam_score`` CUDA kernel on
the card and its plain version on the CPU.

Coded corpora (``quant.mode`` int8 or pq, codes passed as ``qx=``): the
seeds and every beam step score through the codes (``beam_score_int8``
decodes code rows in registers; ``beam_score_pq`` looks codes up in
per-query tables that ``pq_lut`` forms once per tile, outside the loop), and
an exact-f32 rerank tail re-scores the best ``quant.rerank_k`` beam entries
against ``x``, the only place a coded search reads it.

Visited state: ``"dense"`` is the exact oracle, a (B, n+1) bool mask (column
n is scratch); ``"hashed"`` an open-addressed table of ``slots`` int32 ids
per lane, probed linearly, with one scratch column. Hashed inserts that race
for one slot in a single scatter pick a winner that differs between XLA,
PyTorch's CPU and CUDA (and from run to run on CUDA); a lost insert only
allows a re-score, never a duplicate result, so hashed results are held
against this port's dense results, and dense against the reference.

The reference's ``lax.while_loop`` is a Python loop here. Its ``go`` flag
needs a host sync, so it is read every ``_CHECK_EVERY`` iterations: once
every lane has retired, an iteration changes no state (retired lanes do not
expand, insert or move their beam), and the executed-iteration count
``iters`` adds the device-side ``go`` flag, so it equals the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor
from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.kernels.beam_score import ops as bs_ops
from repro_torch.kernels.beam_score.ref import score_lanes
from repro_torch.quant import (
    Quantization,
    QuantizedCorpus,
    int8_decode,
    pq_lut,
    pq_score_codes,
)

METRICS = ("l2", "ip", "cos")
GRAM_DTYPES = ("f32", "bf16")
_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    l: int = 64              # beam width (paper's L)
    k: int = 32              # query-time out-degree limit (paper Eq. 4); <= capacity
    max_iters: int = 256     # hard bound on expansions
    metric: str = "l2"
    topk: int = 1            # results returned per query
    visited: str = "hashed"  # "hashed" (O(slots), n-independent) | "dense" (exact oracle)
    slots: int | None = None  # hashed table size (power of two); None -> resolve_slots
    probes: int = 8          # linear-probe attempts per hashed lookup/insert
    gram_dtype: str = "f32"  # neighbour-gather dtype: "f32" | "bf16"
    quant: Quantization = Quantization()  # corpus representation: f32/bf16/int8/pq

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown metric {self.metric!r}: expected one of {METRICS}")
        if self.gram_dtype not in GRAM_DTYPES:
            raise ValueError(
                f"unknown gram_dtype {self.gram_dtype!r}: expected one of "
                f"{GRAM_DTYPES} (bf16 = gather neighbour vectors in bfloat16, "
                "f32 accumulation)")
        if min(self.l, self.k, self.max_iters, self.topk) < 1:
            raise ValueError(
                "l, k, max_iters and topk must all be >= 1: got "
                f"l={self.l}, k={self.k}, max_iters={self.max_iters}, "
                f"topk={self.topk}")
        if self.topk > self.l:
            raise ValueError(
                f"topk={self.topk} cannot exceed the beam width l={self.l}")
        if self.visited not in ("hashed", "dense"):
            raise ValueError(
                f"unknown visited mode {self.visited!r}: expected \"hashed\" "
                "or \"dense\"")
        if self.probes < 1:
            raise ValueError(f"probes must be >= 1, got {self.probes}")
        if self.slots is not None and (
                self.slots < 8 or (self.slots & (self.slots - 1)) != 0):
            raise ValueError(
                f"slots must be a power of two >= 8, got {self.slots}")
        if not isinstance(self.quant, Quantization):
            raise ValueError(
                f"quant must be a repro_torch.quant.Quantization, got "
                f"{type(self.quant).__name__}")
        if self.quant.is_coded:
            if self.gram_dtype == "bf16":
                raise ValueError(
                    f"quant.mode={self.quant.mode!r} conflicts with "
                    "gram_dtype=\"bf16\": the coded paths gather codes, not "
                    "vectors; pick one compression (use quant.mode=\"bf16\" "
                    "for half-width gathers)")
            if 0 < self.quant.rerank_k < self.topk:
                raise ValueError(
                    f"quant.rerank_k={self.quant.rerank_k} is smaller than "
                    f"topk={self.topk}: the exact-f32 rerank tail must cover "
                    "at least the returned results (or be 0 to disable)")

    @property
    def effective_gram_dtype(self) -> str:
        """``quant.mode="bf16"`` selects the bf16-gather path."""
        return "bf16" if self.quant.mode == "bf16" else self.gram_dtype


def _next_pow2(v: int) -> int:
    return 1 << max(3, (v - 1).bit_length())


def resolve_slots(cfg: SearchConfig, n_entry: int = 1) -> int:
    """Hashed-table size: 2x the bound on visited vertices (seeds plus K per
    expansion), so the load factor stays under 0.5."""
    if cfg.slots is not None:
        return cfg.slots
    return _next_pow2(2 * (cfg.l + n_entry + cfg.max_iters * cfg.k))


def visited_state_bytes(cfg: SearchConfig, n: int, lanes: int, n_entry: int = 1) -> int:
    """Peak visited-state bytes for ``lanes`` concurrent queries, scratch
    column included. Dense scales with n; hashed does not."""
    if cfg.visited == "dense":
        return lanes * (n + 1)
    return lanes * (resolve_slots(cfg, n_entry) + 1) * 4


# --------------------------------------------------------------- visited table
def _probe_slots(ids: torch.Tensor, slots: int, probes: int) -> torch.Tensor:
    """(..., C) ids -> (..., C, probes) int64 table indices: the reference's
    uint32 Knuth hash + bit mix, in int64 arithmetic masked to 32 bits."""
    h = (ids.long() * 2654435761) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    probe = h[..., None] + torch.arange(probes, device=ids.device)
    return probe & (slots - 1)


def _visited_lookup_insert(table: torch.Tensor, ids: torch.Tensor,
                           want: torch.Tensor, probes: int):
    """Membership test + insert of a (B, C) id batch into the (B, slots + 1)
    table, in place (column ``slots`` takes the writes that insert nothing).
    Returns ``seen``. Only ``want`` lanes insert; no false positives ever."""
    b, c = ids.shape
    slots = table.shape[1] - 1
    pidx = _probe_slots(ids, slots, probes)                       # (B, C, P)
    vals = torch.gather(table, 1, pidx.view(b, -1)).view(b, c, probes)
    seen = (vals == ids[..., None]).any(dim=-1)
    empty = vals == -1
    first_empty = empty.to(torch.int32).argmax(dim=-1, keepdim=True)
    ins_slot = torch.gather(pidx, -1, first_empty)[..., 0]
    do_ins = want & ~seen & empty.any(dim=-1)
    table.scatter_(1, torch.where(do_ins, ins_slot, slots), ids)
    return seen


# ------------------------------------------------------------ entry validation
def _validate_entry_points(entry_points, b: int, l: int,
                           device: torch.device) -> torch.Tensor:
    """Normalise ``entry_points`` to (B, E) int32: scalar (broadcast), (B,)
    one seed per query, or (B, E) with E <= L. Anything else raises."""
    eps = torch.as_tensor(entry_points, device=device).to(torch.int32)
    if eps.dim() == 0:
        return eps.reshape(1, 1).expand(b, 1)
    if eps.dim() == 1:
        if eps.shape[0] != b:
            raise ValueError(
                f"entry_points has shape {tuple(eps.shape)} but the query batch "
                f"is {b}; pass a scalar to broadcast, (B,) for one seed per "
                "query, or (B, E) for multi-entry seeding")
        return eps[:, None]
    if eps.dim() == 2:
        if eps.shape[0] != b:
            raise ValueError(
                f"entry_points batch dim {eps.shape[0]} != query batch {b}")
        if eps.shape[1] > l:
            raise ValueError(
                f"{eps.shape[1]} entry points exceed the beam width L={l}")
        return eps
    raise ValueError(f"entry_points must be scalar, (B,) or (B, E); got ndim={eps.dim()}")


def _check_valid(valid, x: torch.Tensor) -> torch.Tensor | None:
    """The (n,) tombstone mask as a bool tensor on x's device (None passes)."""
    if valid is None:
        return None
    valid = torch.as_tensor(valid, device=x.device).bool()
    if tuple(valid.shape) != (x.shape[0],):
        raise ValueError(
            f"valid has shape {tuple(valid.shape)} but the corpus has {x.shape[0]} "
            "rows: pass one bool per row")
    return valid


# -------------------------------------------------------------------- core
class ScoreHooks:
    """Pluggable scoring backend of :func:`_search_impl`.

    The corpus-sharded path (``core/search_sharded.py``) reuses the beam
    body (seeding, visited dedup, merge, retirement, rerank) and swaps only
    the places that touch corpus-sized state for owner-contribute
    collectives. Every hook returns values bit for bit equal to the
    single-device computation it replaces; that is the whole parity
    argument for ``shard="corpus"``.

    ``n``/``capacity`` replace ``x.shape[0]``/``g.capacity`` (a rank holds
    a block of the rows); ``seed``, ``beam`` and ``rerank`` replace the
    three scoring sites; ``any_active`` replaces the termination flag's
    ``any``: every rank must run the same iterations, so the corpus path
    reduces it over the ranks."""

    def __init__(self, n, capacity, seed, beam, rerank, any_active):
        self.n = n                  # global corpus size
        self.capacity = capacity    # global graph capacity (row width)
        self.seed = seed            # (B, E) eps -> (B, E) f32 seed distances
        self.beam = beam            # (B,) u -> ((B, K) nbrs, (B, K) cand_d)
        self.rerank = rerank        # (B, R) rids -> (B, R) exact f32
        self.any_active = any_active  # (B,) bool -> 0-d bool (over the ranks)


def _merge_smallest(d: torch.Tensor, l: int, *others: torch.Tensor):
    """The ``l`` smallest of each row, ascending, ties toward the lower index
    (``lax.top_k(-d, l)``), with ``others`` gathered alongside."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :l]
    return (torch.gather(d, 1, order),
            *(torch.gather(t, 1, order) for t in others))


def _check_codes(cfg: SearchConfig, qx: QuantizedCorpus | None) -> str | None:
    """The coded mode of ``cfg`` (None for f32/bf16); raises when it has no
    codes to search."""
    qmode = cfg.quant.mode if cfg.quant.is_coded else None
    if qmode and qx is None:
        raise ValueError(
            f"cfg.quant selects mode {qmode!r} but no quantized corpus was "
            "passed (qx=): encode with repro_torch.quant.encode_corpus")
    return qmode


def _search_impl(x: torch.Tensor | None, g: G.Graph | None, queries: torch.Tensor,
                 eps: torch.Tensor, cfg: SearchConfig,
                 lane_valid: torch.Tensor | None = None,
                 qx: QuantizedCorpus | None = None,
                 valid: torch.Tensor | None = None,
                 hooks: ScoreHooks | None = None):
    """Returns (ids, dists, work, iters): results, per-lane expansion counts
    and the executed iteration count (a 0-d device tensor). ``valid`` (n,)
    bool: vertices marked False are traversed but never returned.
    ``hooks``: the scoring sites of the corpus-sharded path (``x``, ``g``
    and ``qx`` are then unused)."""
    n = x.shape[0] if hooks is None else hooks.n
    b = queries.shape[0]
    e = eps.shape[1]
    dev = queries.device
    k = min(cfg.k, g.capacity if hooks is None else hooks.capacity)
    inf = torch.tensor(float("inf"), device=dev)
    if hooks is None:
        qmode = _check_codes(cfg, qx)
        xg = x.to(torch.bfloat16) if cfg.effective_gram_dtype == "bf16" else x
        any_fn = torch.Tensor.any
        if qmode == "pq":
            # loop-invariant: once per tile, never inside the beam loop
            lut_a, lut_b, qsq = pq_lut(queries, qx.codebooks, cfg.metric)
    else:
        qmode = cfg.quant.mode if cfg.quant.is_coded else None
        any_fn = hooks.any_active

    # --- seed the beam with E entries (duplicate seeds within a lane inert);
    # seeds score through the corpus the beam scores (f32 rows, or the
    # codes), so every beam distance lives on one scale. Seeds and the rerank
    # sum in score_lanes' fixed order: a lane's result never depends on the
    # tile it rides in
    ar = torch.arange(e, device=dev)
    dup = ((eps[:, :, None] == eps[:, None, :])
           & (ar[None, :, None] > ar[None, None, :])).any(dim=-1)
    if hooks is not None:
        ep_d = hooks.seed(eps)                                    # (B, E)
    elif qmode == "int8":
        ep_d = score_lanes(int8_decode(qx.codes[eps.long()], qx.scale, qx.zero), queries,
                           cfg.metric)
    elif qmode == "pq":
        ep_d = pq_score_codes(qx.codes[eps.long()], lut_a, lut_b, qsq, cfg.metric)
    else:
        ep_d = score_lanes(x[eps.long()], queries, cfg.metric)    # (B, E)
    beam_ids = torch.full((b, cfg.l), -1, dtype=torch.int32, device=dev)
    beam_ids[:, :e] = torch.where(dup, -1, eps)
    beam_d = torch.full((b, cfg.l), float("inf"), device=dev)
    beam_d[:, :e] = torch.where(dup, inf, ep_d)
    expanded = torch.ones((b, cfg.l), dtype=torch.bool, device=dev)
    expanded[:, :e] = dup
    beam_d, beam_ids, expanded = _merge_smallest(beam_d, cfg.l, beam_ids, expanded)

    dense = cfg.visited == "dense"
    if dense:
        visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
        visited.scatter_(1, torch.where(dup, n, eps).long(), True)
    else:
        visited = torch.full((b, resolve_slots(cfg, e) + 1), -1, dtype=torch.int32,
                             device=dev)
        _visited_lookup_insert(visited, eps, ~dup, cfg.probes)

    # padded lanes start retired: they never expand or score
    done = torch.zeros((b,), dtype=torch.bool, device=dev) if lane_valid is None \
        else ~lane_valid.to(dev)
    work = torch.zeros((b,), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    go = any_fn(~done)
    for it in range(cfg.max_iters):
        if it % _CHECK_EVERY == 0 and not bool(go):
            break
        iters += go
        frontier = torch.where(expanded, inf, beam_d)
        slot = torch.argmin(frontier, dim=1, keepdim=True)        # first occurrence
        best_unexp = torch.gather(frontier, 1, slot)[:, 0]
        # per-lane retirement: nothing unexpanded can displace a beam entry
        done = done | (best_unexp > beam_d[:, -1]) | ~torch.isfinite(best_unexp)
        active = ~done
        work += active.to(torch.int32)
        # a retired lane expands -1: the beam kernels write it a lane of
        # padding without reading any prefix or row (cand_ok masks it anyway)
        u = torch.where(active, torch.gather(beam_ids, 1, slot)[:, 0], -1)
        expanded.scatter_(1, slot, torch.gather(expanded, 1, slot) | active[:, None])

        if hooks is not None:
            nbrs, cand_d = hooks.beam(u)
        elif qmode == "int8":
            nbrs, cand_d, _ = bs_ops.beam_score_int8(qx.codes, qx.scale, qx.zero,
                                                     g.neighbors, u, queries, k=k,
                                                     metric=cfg.metric)
        elif qmode == "pq":
            nbrs, cand_d, _ = bs_ops.beam_score_pq(qx.codes, g.neighbors, u, lut_a, lut_b,
                                                   qsq, k=k, metric=cfg.metric)
        else:
            nbrs, cand_d, _ = bs_ops.beam_score(xg, g.neighbors, u, queries, k=k,
                                                metric=cfg.metric)
        cand_ok = (nbrs >= 0) & active[:, None]
        if dense:
            seen = torch.gather(visited, 1, nbrs.clamp(min=0).long())
            fresh = cand_ok & ~seen
            visited.scatter_(1, torch.where(fresh, nbrs, n).long(), True)
        else:
            # exact candidate-vs-beam dedup backs up the lossy hash table
            in_beam = (nbrs[:, :, None] == beam_ids[:, None, :]).any(dim=-1)
            seen = _visited_lookup_insert(visited, nbrs, cand_ok & ~in_beam,
                                          cfg.probes)
            fresh = cand_ok & ~seen & ~in_beam

        beam_d, beam_ids, expanded = _merge_smallest(
            torch.cat([beam_d, torch.where(fresh, cand_d, inf)], dim=1), cfg.l,
            torch.cat([beam_ids, torch.where(fresh, nbrs, -1)], dim=1),
            torch.cat([expanded, ~fresh], dim=1))
        go = any_fn(~done)
    rerank = min(cfg.quant.rerank_k, cfg.l) if qmode else 0
    ok = beam_ids >= 0
    if valid is not None:
        ok &= valid[beam_ids.clamp(min=0).long()]
    if rerank:
        # exact-f32 rerank tail: re-score the best `rerank` (unmasked) beam
        # entries against x, then take the top-k of the exact distances
        # (-1/+inf pad)
        q_d, rids = _merge_smallest(torch.where(ok, beam_d, inf), rerank, beam_ids)
        if hooks is not None:
            exact = hooks.rerank(rids)
        else:
            exact = score_lanes(x[rids.clamp(min=0).long()], queries, cfg.metric)
        exact = torch.where(q_d < inf, exact, inf)
        out_d, out_ids = _merge_smallest(exact, cfg.topk, rids)
        return torch.where(out_d < inf, out_ids, -1), out_d, work, iters
    # masked vertices (tombstones, capacity padding) were traversed like any
    # other but never surface: demote them to (+inf, -1) and re-rank. Without
    # a mask this is the beam's own head; lanes reaching fewer than topk
    # valid vertices pad with (-1, +inf).
    out_d, out_ids = _merge_smallest(torch.where(ok, beam_d, inf), cfg.topk, beam_ids)
    return torch.where(out_d < inf, out_ids, -1), out_d, work, iters


def search(x: torch.Tensor, g: G.Graph, queries: torch.Tensor, entry_points,
           cfg: SearchConfig, qx: QuantizedCorpus | None = None,
           valid: torch.Tensor | None = None):
    """Returns (ids, dists) of shape (B, topk), ascending distance.
    ``entry_points``: scalar | (B,) | (B, E). ``qx``: the encoded corpus
    (``repro_torch.quant.encode_corpus``), required when ``cfg.quant`` is
    int8/pq; ``x`` is then read only by the rerank tail. ``valid``: optional
    (n,) bool mask; vertices marked False (tombstones, capacity padding) are
    traversed but never returned, and lanes reaching fewer than topk valid
    vertices pad with (-1, +inf)."""
    eps = _validate_entry_points(entry_points, queries.shape[0], cfg.l, queries.device)
    ids, dists, _, _ = _search_impl(x, g, queries, eps, cfg, qx=qx,
                                    valid=_check_valid(valid, x))
    return ids, dists


def search_tiled(x, g: G.Graph, queries, entry_points, cfg: SearchConfig,
                 tile_b: int = 256, with_stats: bool = False,
                 lane_valid: torch.Tensor | None = None,
                 device: str | torch.device = "cuda",
                 qx: QuantizedCorpus | None = None,
                 valid: torch.Tensor | None = None,
                 mesh=None, shard: str = "queries"):
    """Stream an arbitrary query count through ``tile_b``-lane tiles; only
    one tile's search state is alive at a time. Results equal :func:`search`.

    ``x``/``queries`` as tensors run on their device; numpy input is placed
    on ``device``. The last tile is padded to ``tile_b`` lanes that start
    retired. ``lane_valid`` (B,) bool retires the lanes marked False at
    iteration 0 (their rows are unspecified). ``qx``: the encoded corpus for
    a coded ``cfg.quant`` and ``valid``, the (n,) tombstone mask (see
    :func:`search`). ``with_stats`` also returns
    {"work": lane-iterations expanded, "launched": iterations executed x
    lanes launched, "tiles", "tile_lanes"}.

    ``mesh`` (``launch.mesh.Mesh``; every rank calls with the same
    arguments and gets the whole result):
      * ``shard="queries"``: the tiles split over the ranks of the mesh's
        "queries" axes, each rank holding the whole corpus and graph and
        running a contiguous run of tiles; the tile shrinks toward
        ceil(b / D) so a small batch never pads to D full tiles. Lanes are
        independent (the kernels and ``score_lanes`` sum in an order that
        does not depend on the tile), so results equal ``mesh=None``'s
        bit for bit.
      * ``shard="corpus"``: the rows of ``x``, ``g`` and ``qx`` split over
        the "rows" axes, and each beam step goes through owner-contribute
        collectives (``core/search_sharded.py``); this entry slices the
        rank's block from the whole arrays. Results equal ``mesh=None``'s
        bit for bit.

    Observability: with ``repro_torch.obs`` enabled the call runs under a
    ``search/tiled`` span that synchronises the card at its end and carries
    ``b, tile_b, shard, l, k, quant, mesh``; with ``with_stats`` also
    ``work, launched, tiles, tile_lanes``, folded into the
    ``search_lane_work_total``, ``search_lanes_launched_total`` and
    ``search_tiles_total`` counters. The launches are the same either way,
    so the results are bit for bit the untraced ones."""
    from repro_torch.obs import trace as _tr
    args = (x, g, queries, entry_points, cfg, tile_b, with_stats, lane_valid, device,
            qx, valid, mesh, shard)
    if not _tr.enabled():
        return _search_tiled(*args)
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import metrics as _mx
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(device)
    with _tr.span("search/tiled") as sp, _ch.span_costs(sp, dev):
        out = _search_tiled(*args)
        _gs.sync(out[0])
        b = int(queries.shape[0])
        sp.set(b=b, tile_b=int(tile_b), shard=shard, l=cfg.l, k=cfg.k,
               quant=cfg.quant.mode, mesh=mesh is not None)
        if with_stats:
            stats = out[2]
            work, launched, tiles = (int(stats[k]) for k in ("work", "launched", "tiles"))
            sp.set(work=work, launched=launched, tiles=tiles,
                   tile_lanes=int(stats["tile_lanes"]))
            reg = _mx.REGISTRY
            reg.counter("search_lane_work_total",
                        help="beam iterations actually expanded "
                             "(tiling-invariant lane work)").inc(work)
            reg.counter("search_lanes_launched_total",
                        help="iterations executed x lanes launched "
                             "(includes padded/retired lanes)").inc(launched)
            reg.counter("search_tiles_total",
                        help="search tiles dispatched").inc(tiles)
    return out


def _search_tiled(x, g, queries, entry_points, cfg, tile_b, with_stats, lane_valid,
                  device, qx, valid, mesh, shard):
    if shard not in ("queries", "corpus"):
        raise ValueError(
            f"unknown shard mode {shard!r}: expected \"queries\" (tiles shard, corpus "
            "replicated) or \"corpus\" (rows shard, queries tile through collectives)")
    x = as_tensor(x, device, torch.float32)
    queries = as_tensor(queries, x.device, torch.float32)
    _check_codes(cfg, qx)
    valid = _check_valid(valid, x)
    b = queries.shape[0]
    eps = _validate_entry_points(entry_points, b, cfg.l, x.device)
    if lane_valid is not None and tuple(lane_valid.shape) != (b,):
        raise ValueError(
            f"lane_valid has shape {tuple(lane_valid.shape)} but the query batch "
            f"is {b}: pass one bool per lane (or None for all-live)")
    if shard == "corpus":
        if mesh is None:
            raise ValueError(
                "shard=\"corpus\" requires mesh=: corpus sharding partitions x and "
                "the adjacency rows over the mesh's \"rows\" axis")
        from repro_torch.core import search_sharded as SS
        x_loc, nb_loc, qx_loc = SS.local_corpus(x, g.neighbors, qx, mesh)
        return SS.search_tiled_corpus(x_loc, nb_loc, queries, eps, cfg, tile_b, mesh,
                                      n=x.shape[0], valid=valid, qx=qx_loc,
                                      with_stats=with_stats, lane_valid=lane_valid)
    tile_b = min(tile_b, b) if b > 0 else 1
    qaxes, n_dev, me = (), 1, 0
    if mesh is not None and b > 0:
        from repro_torch.distributed import comm as C
        from repro_torch.distributed import sharding as SH
        qaxes = SH.mesh_axes(mesh, "queries")
        n_dev = SH.axis_count(mesh, "queries")
        me = C.axis_index(mesh, qaxes)
        tile_b = min(tile_b, -(-b // n_dev))
    pad = (-b) % (tile_b * n_dev)
    lv = torch.arange(b + pad, device=x.device) < b
    if lane_valid is not None:
        lv[:b] &= lane_valid.to(x.device).bool()
    if pad:
        queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
        eps = torch.cat([eps, eps[:1].expand(pad, eps.shape[1])])
    # this rank's contiguous run of tiles (all of them without a mesh)
    span = (b + pad) // n_dev
    ids, dists, work, iters = [], [], [], []
    for s in range(me * span, (me + 1) * span, tile_b):
        out = _search_impl(x, g, queries[s:s + tile_b], eps[s:s + tile_b], cfg,
                           lane_valid=lv[s:s + tile_b], qx=qx, valid=valid)
        for acc, val in zip((ids, dists, work, iters), out):
            acc.append(val)
    if ids:
        ids, dists, work = torch.cat(ids), torch.cat(dists), torch.cat(work)
        iters = torch.stack(iters).sum()
    else:
        ids = torch.zeros((0, cfg.topk), dtype=torch.int32, device=x.device)
        dists = torch.zeros((0, cfg.topk), device=x.device)
        work = torch.zeros((0,), dtype=torch.int32, device=x.device)
        iters = torch.zeros((), dtype=torch.int32, device=x.device)
    if n_dev > 1:
        ids, dists, work = (C.all_gather(t, mesh, qaxes) for t in (ids, dists, work))
        iters = C.psum(iters, mesh, qaxes)
    ids, dists = ids[:b], dists[:b]
    if not with_stats:
        return ids, dists
    stats = {
        "work": int(work[:b].sum()),
        "launched": int(iters) * tile_b,
        "tiles": (b + pad) // tile_b if b > 0 else 0,
        "tile_lanes": tile_b,
    }
    return ids, dists, stats


def default_entry_point(x: torch.Tensor, metric: str = "l2",
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """NSG-style navigating node: the vertex nearest the dataset centroid.
    ``valid``: optional (n,) bool mask; the centroid is then taken over the
    live rows and the seed is a live row (a capacity-padded store's zero
    rows are often centroid-nearest)."""
    if valid is None:
        c = x.mean(dim=0)
        return torch.argmin(D.point_to_points(c, x, metric)).to(torch.int32)
    w = valid.to(x.dtype)
    c = (w @ x) / w.sum().clamp(min=1.0)          # a mat-vec: no (n, d) temporary
    d = torch.where(valid, D.point_to_points(c, x, metric), float("inf"))
    return torch.argmin(d).to(torch.int32)


def default_entry_points(x: torch.Tensor, n_entries: int = 1, metric: str = "l2",
                         generator: torch.Generator | None = None,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """(E,) seed set: the centroid-nearest vertex plus ``n_entries - 1``
    distinct random vertices (torch's random numbers, not JAX's).
    ``valid``: optional (n,) bool mask; every seed is then a live row. The
    draw is the unmasked one with masked rows skipped, so an all-true mask
    gives the unmasked seeds; with fewer live rows than ``n_entries`` the
    tail repeats the centroid seed (duplicate seeds within a lane are
    inert)."""
    n = x.shape[0]
    if n_entries > n:
        raise ValueError(
            f"n_entries={n_entries} exceeds the corpus size n={n}: "
            "entry points are distinct vertices, so at most n can be drawn")
    center = default_entry_point(x, metric, valid=valid)
    if n_entries <= 1:
        return center[None]
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    perm = torch.randperm(n - 1, generator=generator, device=x.device)
    # every row but the centre, in the draw's order; live rows first
    order = perm + (perm >= center).long()
    live = torch.ones_like(order, dtype=torch.bool) if valid is None else valid[order]
    first = torch.sort((~live).int(), stable=True).indices[:n_entries - 1]
    extra = torch.where(live[first], order[first], center.long()).to(torch.int32)
    return torch.cat([center[None], extra])
