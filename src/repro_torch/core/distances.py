"""Distance computation (port of ``repro.core.distances``).

Each formula keeps the reference's exact form: ``pairwise``/``batched_gram``
use ``||a||^2 + ||b||^2 - 2ab`` clamped at 0, ``gather_dists`` the diff form.
Smaller is closer for every metric ("l2" squared, "ip" negative inner
product, "cos" one minus cosine).
"""
from __future__ import annotations

import torch

METRICS = ("l2", "ip", "cos")


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def pairwise(a: torch.Tensor, b: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Dense (na, nb) distance matrix."""
    if metric == "l2":
        d = _sqnorm(a)[:, None] + _sqnorm(b)[None, :] - 2.0 * (a @ b.T)
        return torch.clamp(d, min=0.0)
    if metric == "ip":
        return -(a @ b.T)
    if metric == "cos":
        return 1.0 - _normalize(a) @ _normalize(b).T
    raise ValueError(f"unknown metric {metric!r}")


def point_to_points(q: torch.Tensor, xs: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Distances from one query (d,) to a set (m, d) -> (m,)."""
    return pairwise(q[None, :], xs, metric)[0]


def batched_gram(vecs: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(..., m, d) -> (..., m, m) pairwise distances within each group, f32."""
    vecs = vecs.float()
    if metric == "l2":
        sq = torch.sum(vecs * vecs, dim=-1)
        g = vecs @ vecs.transpose(-1, -2)
        return torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * g, min=0.0)
    if metric == "ip":
        return -(vecs @ vecs.transpose(-1, -2))
    if metric == "cos":
        n = _normalize(vecs)
        return 1.0 - n @ n.transpose(-1, -2)
    raise ValueError(f"unknown metric {metric!r}")


def pairwise_tiled(a: torch.Tensor, b: torch.Tensor, metric: str = "l2",
                   tile_a: int = 1024, k: int | None = None):
    """Tiled pairwise distances; with ``k`` a fused per-tile top-k so the
    (na, nb) matrix never exists whole. Returns the matrix, or ``(dists,
    idx)`` (na, k) ascending with ties toward the lower index."""
    if k is None:
        return torch.cat([pairwise(a[i:i + tile_a], b, metric)
                          for i in range(0, a.shape[0], tile_a)]) \
            if a.shape[0] else a.new_zeros((0, b.shape[0]))
    ds, ids = [], []
    for i in range(0, a.shape[0], tile_a):
        d, idx = topk_smallest(pairwise(a[i:i + tile_a], b, metric), k)
        ds.append(d)
        ids.append(idx)
    if not ds:
        return a.new_zeros((0, k)), torch.zeros((0, k), dtype=torch.int32,
                                                device=a.device)
    return torch.cat(ds), torch.cat(ids).int()


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest of ``d`` (rows, n), ascending, ties broken toward
    the lower column index exactly as ``lax.top_k(-d, k)`` does.

    ``torch.topk`` fixes the k smallest *values* but not which of several
    tied columns it returns, so the selection is rebuilt exactly: every
    column strictly below the k-th value, then the lowest-index columns equal
    to it, then a stable sort by value (columns enter in ascending order)."""
    rows, n = d.shape
    k = min(k, n)
    if rows == 0 or k == 0:
        return d.new_zeros((rows, k)), torch.zeros((rows, k), dtype=torch.int64,
                                                   device=d.device)
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, -1:]
    lt = d < kth
    eq = d == kth
    need = k - lt.sum(dim=1, keepdim=True, dtype=torch.int32)
    sel = lt | (eq & (torch.cumsum(eq, dim=1, dtype=torch.int32) <= need))
    idx = sel.nonzero()[:, 1].view(rows, k)
    vals = torch.gather(d, 1, idx)
    order = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def gather_dists(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 metric: str = "l2") -> torch.Tensor:
    """Distances between row pairs (x[u[i]], x[v[i]]). Invalid (-1) ids -> +inf."""
    xu = x[u.clamp(min=0).long()]
    xv = x[v.clamp(min=0).long()]
    if metric == "l2":
        diff = xu - xv
        d = torch.sum(diff * diff, dim=-1)
    elif metric == "ip":
        d = -torch.sum(xu * xv, dim=-1)
    elif metric == "cos":
        d = 1.0 - torch.sum(_normalize(xu) * _normalize(xv), dim=-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where((u < 0) | (v < 0), torch.full_like(d, float("inf")), d)
