"""Corpus-sharded serving: beam search over a row-partitioned index (port of
``repro.core.search_sharded``).

``search_tiled(..., shard="queries")`` holds the whole corpus and graph on
every rank and divides the query stream. This module is the other axis:
``x``, the adjacency rows and the ``qx`` codes partition over the mesh's
"rows" axes (blocks of ``n_pad / D`` rows a rank), so a rank's corpus memory
drops to about ``n / D`` rows, while the queries stream through in
super-tiles of ``D * tile_b`` lanes: rank s owns lanes
``[s * tile_b, (s + 1) * tile_b)`` of each super-tile and their whole beam
state (beam, visited table, retirement), which stays lane-local and the
single-device loop's.

Owner-contribute collectives
----------------------------
Only the three corpus-touching sites of the beam loop cross the wire,
through :class:`repro_torch.core.search.ScoreHooks`:

1. Frontier adjacency: the lanes' frontier vertices are ``all_gather``-ed
   (D * tile_b ids a step); the rank owning row u contributes
   ``neighbors[u][:k]``, every other INT32_MAX, and a min-reduce rebuilds
   the exact adjacency slice on every rank.
2. Scoring (seeds, beam candidates, rerank tail): every rank scores all
   lanes' candidates against its own row block and contributes the
   distance key of the rows it owns (the key sentinel elsewhere); an
   ``all_to_all`` and a minimum hand each rank its own lanes' keys, and
   ``key_dist`` decodes them bit for bit (the port's int32 key maps every
   float bit pattern one to one, and gloo's and NCCL's MIN take int32).
   The beam candidates go through the single-device step's own wrapper
   (``beam_score``, its int8 and PQ forms: the kernel on the card, its
   plain version on the CPU) over the rank's rows, given each lane's
   candidate list as its adjacency row, with every candidate the rank does
   not own pointed at local row 0 and masked after: each lane's list has
   the single-device step's valid slots in the same places, so every owned
   candidate is scored by the same arithmetic (the reference scores the
   same way with clamped rows, through the jnp oracle it runs on one
   device). Seeds and the rerank sum through ``score_lanes`` (and PQ's
   tables through ``pq_lut``) as the single-device loop does, in an order
   that does not depend on the batch.
3. Termination: every rank must run the same iterations, so the "any lane
   active" bit is a sum over the ranks, read on the host every
   ``search._CHECK_EVERY`` iterations like the single-device flag. Retired
   lanes are fixed points of the beam body.

Queries arrive whole on every rank (the reference gathers lane-sharded
tiles, with the next tile's gather issued ahead), so a super-tile's lanes
are a slice; each rank's results are gathered at the end, and every rank
returns the whole batch.
"""
from __future__ import annotations

import torch

from repro_torch.core import graph as G
from repro_torch.kernels.beam_score import ops as bs_ops
from repro_torch.kernels.beam_score.ref import score_lanes
from repro_torch.quant import QuantizedCorpus, int8_decode, pq_lut, pq_score_codes


def local_block(t: torch.Tensor, mesh, fill=0) -> torch.Tensor:
    """This rank's block of the rows of ``t`` padded with ``fill`` to a
    multiple of the rows axes' shard count (a copy)."""
    from repro_torch.core import shard as SHD
    d = SHD.n_shards(mesh)
    n_pad = -(-t.shape[0] // d) * d
    lo, n_blk = SHD.block_range(n_pad, mesh)
    out = t.new_full((n_blk,) + tuple(t.shape[1:]), fill)
    hi = min(lo + n_blk, t.shape[0])
    if hi > lo:
        out[:hi - lo] = t[lo:hi]
    return out


def local_corpus(x: torch.Tensor, neighbors: torch.Tensor, qx: QuantizedCorpus | None, mesh):
    """(x, adjacency, codes) blocks of this rank: zero rows and empty
    adjacency past n; per-dimension scale/zero and PQ codebooks whole."""
    qx_loc = None
    if qx is not None:
        qx_loc = qx._replace(codes=local_block(qx.codes, mesh))
    return local_block(x, mesh), local_block(neighbors, mesh, -1), qx_loc


def search_tiled_corpus(x_loc: torch.Tensor, nb_loc: torch.Tensor, queries: torch.Tensor,
                        eps: torch.Tensor, cfg, tile_b: int, mesh, n: int,
                        valid: torch.Tensor | None = None, qx: QuantizedCorpus | None = None,
                        with_stats: bool = False, lane_valid: torch.Tensor | None = None):
    """Row-sharded ``search_tiled`` body. ``x_loc``/``nb_loc``/``qx.codes``:
    this rank's block of the padded rows (:func:`local_corpus`); ``n`` the
    corpus's rows; ``queries`` (B, d) and ``eps`` (B, E) (validated) the
    same on every rank; ``valid`` the whole (n,) mask. Returns the whole
    (ids, dists) on every rank, and the stats dict when ``with_stats``."""
    from repro_torch.core import search as S
    from repro_torch.core import shard as SHD
    from repro_torch.distributed import comm as C
    axes = SHD.row_axes(mesh)
    if not axes:
        raise ValueError(f"shard=\"corpus\" needs the logical \"rows\" axis on the mesh "
                         f"(axes {mesh.axis_names}): see RULES in distributed/sharding.py")
    n_dev = C.axis_size(mesh, axes)
    me = C.axis_index(mesh, axes)
    n_blk = x_loc.shape[0]
    if n_blk * n_dev < n or nb_loc.shape[0] != n_blk:
        raise ValueError(f"blocks of {n_blk} corpus and {nb_loc.shape[0]} adjacency rows "
                         f"on {n_dev} ranks cannot hold n = {n}")
    lo = me * n_blk
    dev = x_loc.device
    b = queries.shape[0]
    mcap = nb_loc.shape[1]
    qmode = cfg.quant.mode if cfg.quant.is_coded else None
    if qmode and qx is None:
        raise ValueError(
            f"cfg.quant selects mode {qmode!r} but no quantized corpus was "
            "passed (qx=): encode with repro_torch.quant.encode_corpus")
    if b == 0:
        out = (torch.zeros((0, cfg.topk), dtype=torch.int32, device=dev),
               torch.zeros((0, cfg.topk), device=dev))
        return out + ({"work": 0, "launched": 0, "tiles": 0, "tile_lanes": 0},) \
            if with_stats else out

    tile_b = max(1, min(tile_b, b, -(-b // n_dev)))
    ba = tile_b * n_dev
    pad = (-b) % ba
    lv = torch.arange(b + pad, device=dev) < b
    if lane_valid is not None:
        lv[:b] &= lane_valid.to(dev).bool()
    if pad:
        queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
        eps = torch.cat([eps, eps[:1].expand(pad, eps.shape[1])])
    k = min(cfg.k, mcap)
    x_gram = x_loc.to(torch.bfloat16) \
        if qmode is None and cfg.effective_gram_dtype == "bf16" else x_loc
    # the adjacency rows the beam wrappers read: one lane's candidates a row
    tab = torch.full((n_blk, k), -1, dtype=torch.int32, device=dev)
    sentinel = torch.tensor(G.KEY_SENTINEL, dtype=torch.int32, device=dev)

    def owned(ids):
        """clamp(ids, 0) ownership and block-local rows (the single-device
        clamp of x[ids.clamp(min=0)])."""
        eff = ids.clamp(min=0)
        own = (eff >= lo) & (eff < lo + n_blk)
        return (eff - lo).clamp(0, n_blk - 1).long(), own

    def reduce_keys(keys):
        """(D, tile_b, W) keys a rank computed for every lane block -> this
        rank's lanes' distances: block s of the all_to_all is what rank s
        computed for these lanes, and the minimum picks the owner's."""
        got = C.all_to_all(torch.stack(keys), mesh, axes)
        return G.key_dist(got.amin(0))

    ids_out, dists_out, work_out, iters_out = [], [], [], []
    for t0 in range(0, b + pad, ba):
        qb = [queries[t0 + j * tile_b:t0 + (j + 1) * tile_b] for j in range(n_dev)]
        eb = [eps[t0 + j * tile_b:t0 + (j + 1) * tile_b] for j in range(n_dev)]
        if qmode == "pq":
            # one table set a lane block, as the single-device tile forms it
            luts = [pq_lut(q, qx.codebooks, cfg.metric) for q in qb]

        def score_rows(loc, j):
            """Seed / rerank scores of block-local rows ``loc`` (tile_b, W)
            against lane block j's queries, in the single-device order."""
            if qmode == "int8":
                return score_lanes(int8_decode(qx.codes[loc], qx.scale, qx.zero), qb[j],
                                   cfg.metric)
            if qmode == "pq":
                return pq_score_codes(qx.codes[loc], *luts[j], cfg.metric)
            return score_lanes(x_loc[loc], qb[j], cfg.metric)

        def beam_keys(cand, j):
            """Keys of lane block j's candidates ``cand`` (tile_b, k) global
            ids (-1: padding) through the beam wrapper over this rank's
            rows; the sentinel where another rank owns the candidate."""
            real = (cand >= 0) & (cand < n)
            own = real & (cand >= lo) & (cand < lo + n_blk)
            local = torch.where(own, cand - lo, torch.where(real, 0, -1)).int()
            keys = torch.empty_like(local)
            for s in range(0, local.shape[0], n_blk):   # at most n_blk lanes a call
                c = local[s:s + n_blk]
                tab[:c.shape[0]] = c
                u = torch.arange(c.shape[0], dtype=torch.int32, device=dev)
                if qmode == "int8":
                    _, _, kk = bs_ops.beam_score_int8(qx.codes, qx.scale, qx.zero, tab, u,
                                                      qb[j][s:s + n_blk], k=k, metric=cfg.metric)
                elif qmode == "pq":
                    la, lb, qs = luts[j]
                    _, _, kk = bs_ops.beam_score_pq(qx.codes, tab, u, la[s:s + n_blk], lb,
                                                    qs[s:s + n_blk], k=k, metric=cfg.metric)
                else:
                    _, _, kk = bs_ops.beam_score(x_gram, tab, u, qb[j][s:s + n_blk], k=k,
                                                 metric=cfg.metric)
                keys[s:s + c.shape[0]] = kk
            return torch.where(own | ~real, keys, sentinel)

        def seed_hook(_eps_mine):
            keys = []
            for j in range(n_dev):
                eff = torch.where(eb[j] < 0, eb[j] + n, eb[j]).clamp(0, n - 1)
                loc, own = owned(eff)
                keys.append(torch.where(own, G.dist_key(score_rows(loc, j)), sentinel))
            return reduce_keys(keys)

        def beam_hook(u):
            u_all = C.all_gather(u, mesh, axes)                          # (BA,)
            uloc, uown = owned(u_all)
            uown &= u_all >= 0
            contrib = torch.where(uown[:, None], nb_loc[uloc, :k], G.INT32_MAX)
            nbrs_all = C.pmin(contrib, mesh, axes)                       # (BA, k)
            # a frontier id outside [0, n) gives a lane of padding, an id
            # outside [0, n) a padding slot: the beam kernels' rule
            nbrs_all = torch.where((nbrs_all == G.INT32_MAX) | (nbrs_all >= n), -1, nbrs_all)
            cand_d = reduce_keys([beam_keys(nbrs_all[j * tile_b:(j + 1) * tile_b], j)
                                  for j in range(n_dev)])
            return nbrs_all[me * tile_b:(me + 1) * tile_b], cand_d

        def rerank_hook(rids):
            r_all = C.all_gather(rids, mesh, axes)                       # (BA, R)
            keys = []
            for j in range(n_dev):
                loc, own = owned(r_all[j * tile_b:(j + 1) * tile_b])
                keys.append(torch.where(own, G.dist_key(
                    score_lanes(x_loc[loc], qb[j], cfg.metric)), sentinel))
            return reduce_keys(keys)

        def any_hook(mask):
            return C.psum(mask.any().int(), mesh, axes) > 0

        hooks = S.ScoreHooks(n=n, capacity=mcap, seed=seed_hook, beam=beam_hook,
                             rerank=rerank_hook, any_active=any_hook)
        mine = slice(t0 + me * tile_b, t0 + (me + 1) * tile_b)
        out = S._search_impl(None, None, queries[mine], eps[mine], cfg,
                             lane_valid=lv[mine], valid=valid, hooks=hooks)
        for acc, val in zip((ids_out, dists_out, work_out, iters_out), out):
            acc.append(val)

    def whole(parts):
        """(T * tile_b, ...) of this rank -> (B, ...) in lane order: super
        tile t, lane block s (rank s), lane i."""
        mine = torch.stack(parts)                                    # (T, tile_b, ...)
        got = C.all_gather(mine[None], mesh, axes)                   # (D, T, tile_b, ...)
        return got.transpose(0, 1).reshape((-1,) + tuple(mine.shape[2:]))[:b]

    ids, dists = whole(ids_out), whole(dists_out)
    if not with_stats:
        return ids, dists
    return ids, dists, {
        "work": int(whole(work_out).sum()),
        "launched": int(torch.stack(iters_out).sum()) * ba,
        "tiles": len(iters_out),
        "tile_lanes": ba,
    }
