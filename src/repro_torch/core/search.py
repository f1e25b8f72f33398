"""Graph traversal search (paper Algorithm 1 + Eq. 4), port of
``repro.core.search``.

Best-first beam search with beam width L over fixed-shape state: a (B, L)
beam (ids / dists / expanded) plus per-query visited bookkeeping. Eq. 4
truncates each expanded vertex's adjacency to its first K entries (rows are
distance-sorted). The gather+score step is the ``beam_score`` CUDA kernel on
the card and its plain version on the CPU.

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
from repro_torch.kernels.beam_score.ref import score_block

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


# -------------------------------------------------------------------- core
def _merge_smallest(d: torch.Tensor, l: int, *others: torch.Tensor):
    """The ``l`` smallest of each row, ascending, ties toward the lower index
    (``lax.top_k(-d, l)``), with ``others`` gathered alongside."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :l]
    return (torch.gather(d, 1, order),
            *(torch.gather(t, 1, order) for t in others))


def _search_impl(x: torch.Tensor, g: G.Graph, queries: torch.Tensor,
                 eps: torch.Tensor, cfg: SearchConfig,
                 lane_valid: torch.Tensor | None = None):
    """Returns (ids, dists, work, iters): results, per-lane expansion counts
    and the executed iteration count (a 0-d device tensor)."""
    n = x.shape[0]
    b = queries.shape[0]
    e = eps.shape[1]
    dev = queries.device
    k = min(cfg.k, g.capacity)
    inf = torch.tensor(float("inf"), device=dev)
    xg = x.to(torch.bfloat16) if cfg.gram_dtype == "bf16" else x

    # --- seed the beam with E entries (duplicate seeds within a lane inert);
    # seeds read the f32 corpus and score through score_block
    ar = torch.arange(e, device=dev)
    dup = ((eps[:, :, None] == eps[:, None, :])
           & (ar[None, :, None] > ar[None, None, :])).any(dim=-1)
    ep_d = score_block(x[eps.long()], queries, cfg.metric)        # (B, E)
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
    go = (~done).any()
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
        u = torch.where(active, torch.gather(beam_ids, 1, slot)[:, 0], 0)
        expanded.scatter_(1, slot, torch.gather(expanded, 1, slot) | active[:, None])

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
        go = (~done).any()
    return beam_ids[:, :cfg.topk], beam_d[:, :cfg.topk], work, iters


def search(x: torch.Tensor, g: G.Graph, queries: torch.Tensor, entry_points,
           cfg: SearchConfig):
    """Returns (ids, dists) of shape (B, topk), ascending distance.
    ``entry_points``: scalar | (B,) | (B, E)."""
    eps = _validate_entry_points(entry_points, queries.shape[0], cfg.l, queries.device)
    ids, dists, _, _ = _search_impl(x, g, queries, eps, cfg)
    return ids, dists


def search_tiled(x, g: G.Graph, queries, entry_points, cfg: SearchConfig,
                 tile_b: int = 256, with_stats: bool = False,
                 lane_valid: torch.Tensor | None = None,
                 device: str | torch.device = "cuda"):
    """Stream an arbitrary query count through ``tile_b``-lane tiles; only
    one tile's search state is alive at a time. Results equal :func:`search`.

    ``x``/``queries`` as tensors run on their device; numpy input is placed
    on ``device``. The last tile is padded to ``tile_b`` lanes that start
    retired. ``lane_valid`` (B,) bool retires the lanes marked False at
    iteration 0 (their rows are unspecified). ``with_stats`` also returns
    {"work": lane-iterations expanded, "launched": iterations executed x
    lanes launched, "tiles", "tile_lanes"}."""
    x = as_tensor(x, device, torch.float32)
    queries = as_tensor(queries, x.device, torch.float32)
    b = queries.shape[0]
    eps = _validate_entry_points(entry_points, b, cfg.l, x.device)
    if lane_valid is not None and tuple(lane_valid.shape) != (b,):
        raise ValueError(
            f"lane_valid has shape {tuple(lane_valid.shape)} but the query batch "
            f"is {b}: pass one bool per lane (or None for all-live)")
    tile_b = min(tile_b, b) if b > 0 else 1
    pad = (-b) % tile_b
    lv = torch.arange(b + pad, device=x.device) < b
    if lane_valid is not None:
        lv[:b] &= lane_valid.to(x.device).bool()
    if pad:
        queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
        eps = torch.cat([eps, eps[:1].expand(pad, eps.shape[1])])
    ids, dists, work, iters = [], [], [], []
    for s in range(0, b + pad, tile_b):
        out = _search_impl(x, g, queries[s:s + tile_b], eps[s:s + tile_b], cfg,
                           lane_valid=lv[s:s + tile_b])
        for acc, val in zip((ids, dists, work, iters), out):
            acc.append(val)
    if ids:
        ids, dists = torch.cat(ids)[:b], torch.cat(dists)[:b]
    else:
        ids = torch.zeros((0, cfg.topk), dtype=torch.int32, device=x.device)
        dists = torch.zeros((0, cfg.topk), device=x.device)
    if not with_stats:
        return ids, dists
    stats = {
        "work": int(torch.cat(work)[:b].sum()) if work else 0,
        "launched": int(torch.stack(iters).sum()) * tile_b if iters else 0,
        "tiles": len(iters),
        "tile_lanes": tile_b,
    }
    return ids, dists, stats


def default_entry_point(x: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """NSG-style navigating node: the vertex nearest the dataset centroid."""
    c = x.mean(dim=0)
    return torch.argmin(D.point_to_points(c, x, metric)).to(torch.int32)


def default_entry_points(x: torch.Tensor, n_entries: int = 1, metric: str = "l2",
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """(E,) seed set: the centroid-nearest vertex plus ``n_entries - 1``
    distinct random vertices (torch's random numbers, not JAX's)."""
    n = x.shape[0]
    if n_entries > n:
        raise ValueError(
            f"n_entries={n_entries} exceeds the corpus size n={n}: "
            "entry points are distinct vertices, so at most n can be drawn")
    center = default_entry_point(x, metric)
    if n_entries <= 1:
        return center[None]
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    extra = torch.randperm(n - 1, generator=generator, device=x.device)[:n_entries - 1]
    extra = (extra + (extra >= center).long()).to(torch.int32)
    return torch.cat([center[None], extra])
