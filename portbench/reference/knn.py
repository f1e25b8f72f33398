"""Exact k nearest neighbours under squared L2, by brute force in float64."""
from __future__ import annotations

import torch


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance of row i of ``a`` to row i of ``b``, summed in
    float64 from the differences (no cancellation)."""
    diff = a.double() - b.double()
    return (diff * diff).sum(dim=1)


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int, q_block: int = 2048,
              x_block: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` rows of ``x`` nearest each row of ``q``: (ids int64 (nq, k),
    squared distances float64 (nq, k)), ascending. Distances in float64
    (``|x|^2 - 2 q.x + |q|^2``, exact to about 1e-13 of the norms), one
    (q_block, x_block) block alive at a time; candidates of a block are its
    top k, merged with the running best by a stable sort (a tie across
    blocks keeps the lower index)."""
    nq = q.shape[0]
    ids = torch.empty((nq, k), dtype=torch.int64, device=q.device)
    best = torch.empty((nq, k), dtype=torch.float64, device=q.device)
    for qs in range(0, nq, q_block):
        qb = q[qs:qs + q_block].double()
        qn = (qb * qb).sum(dim=1, keepdim=True)
        run_d = torch.full((qb.shape[0], 0), float("inf"), dtype=torch.float64, device=q.device)
        run_i = torch.zeros((qb.shape[0], 0), dtype=torch.int64, device=q.device)
        for xs in range(0, x.shape[0], x_block):
            xb = x[xs:xs + x_block].double()
            d = torch.addmm((xb * xb).sum(dim=1)[None, :], qb, xb.T, alpha=-2.0).add_(qn)
            kk = min(k, d.shape[1])
            bd, bi = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            del d
            cat_d = torch.cat([run_d, bd], dim=1)
            cat_i = torch.cat([run_i, bi + xs], dim=1)
            order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
            run_d, run_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
        ids[qs:qs + q_block] = run_i
        best[qs:qs + q_block] = run_d
    return ids, best
