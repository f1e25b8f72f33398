"""What every search answer must satisfy, and its recall against the exact
neighbours.

An answer to one query is ``topk`` ids of corpus rows with their listed
distances: each id in [0, n), no id twice, distances finite and ascending,
each the squared L2 distance of the query to that row.
"""
from __future__ import annotations

import torch

from .knn import sq_dists

ROW_BLOCK = 16384


def check_answers(x: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
                  dists: torch.Tensor, sample: torch.Tensor,
                  query_of: torch.Tensor | None = None) -> dict:
    """``bad``: answer rows (of all of ``ids``) that break an invariant;
    ``dist_rel_err``: the largest |listed - exact| / exact over the answer
    rows ``sample``, exact distances summed in float64 over the entries with
    an id in range. Answer row j answers ``queries[query_of[j]]`` (``query_of``
    None: ``queries[j]``)."""
    n = x.shape[0]
    bad = 0
    for s in range(0, ids.shape[0], ROW_BLOCK):
        i = ids[s:s + ROW_BLOCK].long()
        d = dists[s:s + ROW_BLOCK]
        out = (i < 0) | (i >= n) | ~torch.isfinite(d)
        srt = torch.sort(i, dim=1).values
        broken = out.any(dim=1) | (srt[:, 1:] == srt[:, :-1]).any(dim=1) \
            | (d[:, 1:] < d[:, :-1]).any(dim=1)
        bad += int(broken.sum())
    err = torch.zeros((), dtype=torch.float64, device=x.device)
    topk = ids.shape[1]
    for s in range(0, sample.shape[0], ROW_BLOCK // topk + 1):
        j = sample[s:s + ROW_BLOCK // topk + 1].long()
        i = ids[j].long()
        ok = (i >= 0) & (i < n)
        asked = j if query_of is None else query_of[j].long()
        qrow = asked[:, None].expand_as(i)[ok]
        exact = sq_dists(queries[qrow], x[i[ok]])
        rel = (dists[j][ok].double() - exact).abs() / exact.clamp(min=1e-30)
        if rel.numel():
            err = torch.maximum(err, rel.max())
    return {"bad": bad, "rows": int(ids.shape[0]), "dist_rel_err": float(err)}


def recall(ids: torch.Tensor, true_ids: torch.Tensor) -> float:
    """Set recall: the mean share of each row of ``true_ids`` found in the
    same row of ``ids``."""
    hits = 0
    for s in range(0, ids.shape[0], ROW_BLOCK):
        a = ids[s:s + ROW_BLOCK].long()
        t = true_ids[s:s + ROW_BLOCK].long()
        hits += int((t[:, :, None] == a[:, None, :]).any(dim=2).sum())
    return hits / true_ids.numel()
