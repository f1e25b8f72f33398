"""Plain PyTorch version of a sweep's merge of the prune's output: the kept
rows sorted (flags OLD), then ``core.graph.merge_candidate_edges`` of the
replacement edges (flagged NEW)."""
from __future__ import annotations

import torch

from repro_torch.core import graph as G


def bucket_merge_ref(ids: torch.Tensor, dists: torch.Tensor, keep: torch.Tensor,
                     red_w: torch.Tensor, red_d: torch.Tensor, n_buckets: int | None,
                     cap: int | None = None, merge: str = "bucketed"):
    """ids/dists (n, m) of the graph that went into the prune, its keep mask
    and redirects red_w/red_d (n, m) -> (merged Graph of rows of ``cap``
    (default m), the number of real candidates as a 0-d int64 tensor).
    A real candidate is an edge w = red_w[u, j] -> v = ids[u, j] with w in
    [0, n), v >= 0, w != v and red_d not NaN: the edges a bucketed merge
    scatters. ``merge="sort"`` merges the same edges by the exact sort
    oracle instead (``n_buckets`` unused)."""
    inf = torch.tensor(float("inf"), device=dists.device)
    pruned = G.sort_rows(G.Graph(torch.where(keep, ids, -1), torch.where(keep, dists, inf),
                                 torch.zeros(ids.shape, dtype=torch.uint8, device=ids.device)))
    cand_dst = torch.where(red_w >= 0, ids, -1)
    out = G.merge_candidate_edges(pruned, red_w.reshape(-1), cand_dst.reshape(-1),
                                  red_d.reshape(-1), cap=cap, merge=merge, n_buckets=n_buckets)
    real = (red_w >= 0) & (red_w < ids.shape[0]) & (ids >= 0) & (red_w != ids) \
        & ~torch.isnan(red_d)
    return out, real.sum()
