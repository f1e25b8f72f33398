"""What every row of an RNN-Descent graph must satisfy, worked out again
from the corpus.

A row of the (n, M) adjacency lists its vertex's out-neighbours: each
entry an id in [0, n) other than the row's own, or -1 for an empty slot;
no id twice; live entries first, in ascending order of their listed
distance, empty slots after them with distance +inf; and each listed
distance the squared L2 distance of the two vectors.
"""
from __future__ import annotations

import torch

from .knn import sq_dists

PAIR_BLOCK = 131072


def check_rows(x: torch.Tensor, neighbors: torch.Tensor, dists: torch.Tensor,
               rows: torch.Tensor) -> dict:
    """The graph's ``rows`` held to the invariants above: ``bad`` counts
    entries that break one (an id out of range or the row's own, a repeat,
    a live entry after an empty slot, a distance below its left neighbour's,
    an empty slot whose distance is not +inf); ``dist_rel_err`` is the
    largest |listed - exact| / exact over the live entries with an id in
    range, the exact distance summed in float64; ``live`` counts those."""
    n = x.shape[0]
    rows = rows.long()
    nb = neighbors[rows].long()
    dd = dists[rows].float()
    live = nb >= 0
    bad_id = live & ((nb >= n) | (nb == rows[:, None]))
    bad_id |= nb < -1
    srt = torch.sort(torch.where(live, nb, -1 - torch.arange(nb.shape[1], device=nb.device)),
                     dim=1).values
    repeat = srt[:, 1:] == srt[:, :-1]
    after_empty = live[:, 1:] & ~live[:, :-1]
    descent = live[:, 1:] & (dd[:, 1:] < dd[:, :-1])
    empty_not_inf = ~live & (dd != float("inf"))
    bad = int(bad_id.sum() + repeat.sum() + after_empty.sum() + descent.sum()
              + empty_not_inf.sum())
    ok = live & ~bad_id
    src = rows[:, None].expand_as(nb)[ok]
    dst = nb[ok]
    listed = dd[ok].double()
    err = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, src.shape[0], PAIR_BLOCK):
        exact = sq_dists(x[src[s:s + PAIR_BLOCK]], x[dst[s:s + PAIR_BLOCK]])
        rel = (listed[s:s + PAIR_BLOCK] - exact).abs() / exact.clamp(min=1e-30)
        err = torch.maximum(err, rel.max())
    return {"bad": bad, "live": int(src.shape[0]), "dist_rel_err": float(err)}
