"""Evaluation utilities (port of ``repro.core.eval``): brute-force ground
truth, recall, degree statistics, connectivity, timing."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.kernels.pairwise_l2 import ops as pl2


def ground_truth(x: torch.Tensor, queries: torch.Tensor, k: int = 1,
                 metric: str = "l2", tile: int = 1024,
                 valid: torch.Tensor | None = None):
    """Exact top-k by tiled brute force -> (dists (Q, k) f32, ids (Q, k)
    int32), ascending, ties toward the lower index. Only one (tile, n)
    distance block is alive at a time. ``l2`` goes through the
    ``pairwise_l2`` kernel (its plain version on the CPU); ``ip``/``cos``
    through the plain matmul form, as the reference's jnp branch computes.
    ``valid``: optional (n,) bool mask; masked rows (tombstones, capacity
    padding) are left out, and a tail with fewer than k valid rows pads
    with (+inf, -1)."""
    if valid is not None:
        valid = valid.to(x.device)
    ds, ids = [], []
    for s in range(0, queries.shape[0], tile):
        t = queries[s:s + tile]
        d = pl2.pairwise_l2(t, x) if metric == "l2" else D.pairwise(t, x, metric)
        if valid is not None:
            d = torch.where(valid[None, :], d, float("inf"))
        dd, ii = D.topk_smallest(d, k)
        del d
        if valid is not None:
            ii = torch.where(dd < float("inf"), ii, -1)
        ds.append(dd)
        ids.append(ii.int())
    if not ds:
        return (queries.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int32, device=queries.device))
    return torch.cat(ds), torch.cat(ids)


def recall_at_k(pred_ids: torch.Tensor, gt_ids: torch.Tensor) -> float:
    """Fraction of queries whose true NN (gt column 0) appears in pred."""
    hit = (pred_ids == gt_ids[:, :1]).any(dim=1)
    return float(hit.float().mean())


def recall_topk(pred_ids: torch.Tensor, gt_ids: torch.Tensor,
                valid: torch.Tensor | None = None) -> float:
    """Set recall: mean fraction of the true top-k present in pred (the
    paper's recall@k).

    ``valid``: optional (n,) bool mask for churned corpora. Masked ids count
    on neither side: a masked gt column leaves the denominator, a masked
    prediction never scores a hit, and a query with no valid gt column
    drops out of the mean."""
    if valid is None:
        hit = (pred_ids[:, :, None] == gt_ids[:, None, :]).any(dim=1)
        return float(hit.float().mean(dim=1).mean())
    valid = valid.to(gt_ids.device)
    gt_ok = (gt_ids >= 0) & valid[gt_ids.clamp(min=0).long()]
    pred_ok = (pred_ids >= 0) & valid[pred_ids.clamp(min=0).long()]
    match = (pred_ids[:, :, None] == gt_ids[:, None, :]) & pred_ok[:, :, None]
    hit = match.any(dim=1) & gt_ok
    denom = gt_ok.sum(dim=1)
    per_q = hit.sum(dim=1).float() / denom.clamp(min=1).float()
    any_gt = denom > 0
    return float(torch.where(any_gt, per_q, 0.0).sum() / any_gt.sum().clamp(min=1).float())


def evaluate_search(x, g: G.Graph, queries, gt_ids, cfg, entry_points=None,
                    tile_b: int = 256, repeats: int = 2,
                    valid: torch.Tensor | None = None) -> dict:
    """Recall and queries/sec over ``search_tiled`` (best of ``repeats``).
    ``valid``: the (n,) tombstone mask, threaded through the search, the
    default entry point and :func:`recall_topk` (pass ``gt_ids`` computed
    with the same mask)."""
    from repro_torch.core import search as S

    if entry_points is None:
        entry_points = S.default_entry_point(x, cfg.metric, valid=valid)
    sec, (ids, _) = timed(S.search_tiled, x, g, queries, entry_points, cfg,
                          tile_b=tile_b, repeats=repeats, valid=valid)
    lanes = min(tile_b, queries.shape[0])
    return {
        "recall_at_1": recall_at_k(ids, gt_ids),
        "recall_topk": recall_topk(ids, gt_ids, valid=valid),
        "qps": queries.shape[0] / sec,
        "visited_mode": cfg.visited,
        "visited_bytes_per_tile": S.visited_state_bytes(cfg, x.shape[0], lanes),
        "search_path": "cuda-kernel" if x.is_cuda else "plain",
    }


def degree_stats(g: G.Graph) -> dict:
    out_d = G.out_degrees(g).cpu().numpy()
    in_d = G.in_degrees(g).cpu().numpy()
    return {
        "avg_out_degree": float(out_d.mean()),
        "max_out_degree": int(out_d.max()),
        "avg_in_degree": float(in_d.mean()),
        "max_in_degree": int(in_d.max()),
        "out_degree_hist": np.bincount(out_d, minlength=1).tolist(),
    }


def connectivity_lower_bound(g: G.Graph, entry: int, iters: int = 64) -> float:
    """Fraction of vertices reachable from ``entry`` within ``iters`` BFS
    frontier expansions. Stops early at the fixpoint (the reach set only
    grows, so the result is the same)."""
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
    return int(reach.sum()) / n


def timed(fn: Callable, *args, repeats: int = 1, **kw) -> tuple[float, object]:
    """Wall-clock a call (best of ``repeats``), synchronising the card
    before and after when CUDA is in use; returns (sec, result). Each repeat
    lands on the obs trace as an ``eval/timed`` span when tracing is on
    (``obs.trace.timed`` measures unconditionally)."""
    from repro_torch.obs import trace
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    name = getattr(fn, "__name__", type(fn).__name__)
    best, out = float("inf"), None
    for _ in range(repeats):
        sync()
        with trace.timed("eval/timed", fn=name) as tm:
            out = fn(*args, **kw)
            sync()
        best = min(best, tm.seconds)
    return best, out
