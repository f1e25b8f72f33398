"""Plain PyTorch version of the fused gather+score beam step.

:func:`score_block` mirrors ``repro.kernels.beam_score.ref.score_block``:
l2 is ``max(||q||^2 + ||v||^2 - 2 q.v, 0)`` (not the diff form), ip is
``-q.v``, cos normalises both sides with the 1e-12 clamp. Everything is
upcast to f32 before any arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import dist_key


def score_block(vecs: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """(..., K, d) gathered block x (..., d) queries -> (..., K) f32."""
    v = vecs.float()
    qq = q.float()

    def sqsum(a):
        return torch.einsum("...d,...d->...", a, a)

    if metric == "l2":
        dot = torch.einsum("...kd,...d->...k", v, qq)
        return torch.clamp(sqsum(qq)[..., None] + sqsum(v) - 2.0 * dot, min=0.0)
    if metric == "ip":
        return -torch.einsum("...kd,...d->...k", v, qq)
    if metric == "cos":
        vn = v / torch.clamp(torch.sqrt(sqsum(v))[..., None], min=1e-12)
        qn = qq / torch.clamp(torch.sqrt(sqsum(qq))[..., None], min=1e-12)
        return 1.0 - torch.einsum("...kd,...d->...k", vn, qn)
    raise ValueError(f"unknown metric {metric!r}")


def beam_score_ref(x: torch.Tensor, neighbors: torch.Tensor, u: torch.Tensor,
                   queries: torch.Tensor, k: int, metric: str = "l2"):
    """``u`` (B,) frontier ids -> each lane's first ``k`` neighbours (Eq. 4
    prefix), scored against ``queries`` (B, d). Returns (ids i32 (-1 pad),
    dists f32 (+inf pad), keys i32), each (B, k)."""
    k = min(k, neighbors.shape[1])
    nbrs = neighbors[u.long()][:, :k]
    d = score_block(x[nbrs.clamp(min=0).long()], queries, metric)
    valid = nbrs >= 0
    d = torch.where(valid, d, torch.tensor(float("inf"), device=d.device))
    return torch.where(valid, nbrs, -1), d, dist_key(d)
