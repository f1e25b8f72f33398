"""RNG Strategy (paper Algorithm 3) and its fused RNN-Descent variant (port
of ``repro.core.rng``).

Both are one triangular scan over a distance-sorted candidate list:

    keep[i]  <=>  forall kept j < i :  d(u, v_i) < d(v_i, v_j)

and the fused variant also returns, for each dropped candidate v, the first
kept neighbour w that dominated it (RNN-Descent's replacement edge w -> v).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RNGScanResult(NamedTuple):
    keep: torch.Tensor          # (C, M) bool — candidate survives the prune
    redirect_w: torch.Tensor    # (C, M) int32 — dominating kept neighbour id, -1 if kept
    redirect_d: torch.Tensor    # (C, M) f32 — d(v, w) for the replacement edge


def rng_scan(ids: torch.Tensor, dists: torch.Tensor, pair: torch.Tensor,
             skip_pair: torch.Tensor | None = None) -> RNGScanResult:
    """Vectorised triangular RNG scan over (C, M) rows sorted by distance.
    ``pair`` (C, M, M) holds candidate-pair distances; ``skip_pair`` exempts
    pairs (old-old pairs were already verified)."""
    c, m = ids.shape
    valid = ids >= 0
    inf = torch.tensor(float("inf"), device=pair.device)
    pair = torch.where(valid[:, :, None] & valid[:, None, :], pair, inf)
    keep = torch.zeros((c, m), dtype=torch.bool, device=ids.device)
    red_w = torch.full((c, m), -1, dtype=torch.int32, device=ids.device)
    red_d = torch.full((c, m), float("inf"), dtype=torch.float32, device=ids.device)
    rows = torch.arange(c, device=ids.device)
    for i in range(m):
        # keep[:, j >= i] is still False, so the j < i constraint is implicit
        fail = keep & (pair[:, i, :] <= dists[:, i:i + 1])
        if skip_pair is not None:
            fail &= ~skip_pair[:, i, :]
        any_fail = fail.any(dim=1) & valid[:, i]      # padded slots never redirect
        first_j = fail.to(torch.int32).argmax(dim=1)  # first occurrence
        keep[:, i] = valid[:, i] & ~any_fail
        red_w[:, i] = torch.where(any_fail, ids[rows, first_j], -1)
        red_d[:, i] = torch.where(any_fail, pair[rows, i, first_j], inf)
    return RNGScanResult(keep, red_w, red_d)


def rng_prune_rows(x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
                   metric: str = "l2", chunk: int = 1024) -> torch.Tensor:
    """Plain RNG Strategy (Algorithm 3) over many distance-sorted rows:
    returns the keep mask (every candidate "new", so no pair is exempt)."""
    from repro_torch.kernels.rng_prune import ops as rng_ops  # imports this module
    return rng_ops.rng_prune(x, ids, dists, None, metric=metric, chunk=chunk)[0].bool()
