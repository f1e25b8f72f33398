"""Plain PyTorch versions of the fused gather+score beam step, over an f32
or bf16 corpus, int8 codes or PQ codes.

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


def lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in one fixed order (a halving tree of
    elementwise adds): each output's rounding depends on its own row only,
    never on how many rows share the call. A matmul or a reduction kernel
    may pick its split of the sum by the batch (cuBLAS splits K when few
    rows would fill the card), and then a lane's bits change with the tile
    it rides in."""
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        head = t[..., :h] + t[..., h:2 * h]
        t = torch.cat([head, t[..., 2 * h:]], dim=-1) if t.shape[-1] % 2 else head
    return t[..., 0]


def score_lanes(vecs: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """:func:`score_block` with every sum in :func:`lane_sum`'s fixed order:
    the search's seeds and exact rerank, whose results must not depend on
    the tile width. Equal to :func:`score_block` wherever the sums are exact
    (integer-valued inputs)."""
    v = vecs.float()
    qq = q.float()[..., None, :]
    if metric == "l2":
        return torch.clamp(lane_sum(qq * qq) + lane_sum(v * v) - 2.0 * lane_sum(v * qq),
                           min=0.0)
    if metric == "ip":
        return -lane_sum(v * qq)
    if metric == "cos":
        vn = v / torch.clamp(torch.sqrt(lane_sum(v * v))[..., None], min=1e-12)
        qn = qq / torch.clamp(torch.sqrt(lane_sum(qq * qq))[..., None], min=1e-12)
        return 1.0 - lane_sum(vn * qn)
    raise ValueError(f"unknown metric {metric!r}")


def beam_score_ref(x: torch.Tensor, neighbors: torch.Tensor, u: torch.Tensor,
                   queries: torch.Tensor, k: int, metric: str = "l2"):
    """``u`` (B,) frontier ids -> each lane's first ``k`` neighbours (Eq. 4
    prefix), scored against ``queries`` (B, d). Returns (ids i32 (-1 pad),
    dists f32 (+inf pad), keys i32), each (B, k). As in the kernels, a
    frontier id outside [0, n) gives a lane of padding (the search passes -1
    for a retired lane), and so does an adjacency id outside [0, n) its
    slot."""
    nbrs = _prefix(neighbors, u, k)
    return _finish(nbrs, score_block(x[nbrs.clamp(min=0).long()], queries, metric))


def _prefix(neighbors: torch.Tensor, u: torch.Tensor, k: int) -> torch.Tensor:
    """(B, min(k, M)) adjacency prefixes of ``u``, -1 for every id outside
    [0, n): a whole row for such a frontier id, a slot for such a
    neighbour."""
    n = neighbors.shape[0]
    ok = (u >= 0) & (u < n)
    nbrs = neighbors[torch.where(ok, u, 0).long()][:, :min(k, neighbors.shape[1])]
    return torch.where(ok[:, None] & (nbrs < n), nbrs, -1)


def _finish(nbrs: torch.Tensor, d: torch.Tensor):
    valid = nbrs >= 0
    d = torch.where(valid, d, torch.tensor(float("inf"), device=d.device))
    return torch.where(valid, nbrs, -1), d, dist_key(d)


def beam_score_int8_ref(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                        neighbors: torch.Tensor, u: torch.Tensor, queries: torch.Tensor,
                        k: int, metric: str = "l2"):
    """int8 corpus: gather (B, k, d) code rows, decode and score through
    ``int8_score_block``. Same return as :func:`beam_score_ref`."""
    from repro_torch.quant.quantization import int8_score_block
    nbrs = _prefix(neighbors, u, k)
    d = int8_score_block(codes[nbrs.clamp(min=0).long()], scale, zero, queries, metric)
    return _finish(nbrs, d)


def beam_score_pq_ref(codes: torch.Tensor, neighbors: torch.Tensor, u: torch.Tensor,
                      lut_a: torch.Tensor, lut_b: torch.Tensor, qsq: torch.Tensor,
                      k: int, metric: str = "l2"):
    """PQ corpus: gather (B, k, m) uint8 code rows and score them against the
    per-query tables of ``pq_lut`` through ``pq_score_codes``. Same return
    as :func:`beam_score_ref`."""
    from repro_torch.quant.quantization import pq_score_codes
    nbrs = _prefix(neighbors, u, k)
    d = pq_score_codes(codes[nbrs.clamp(min=0).long()], lut_a, lut_b, qsq, metric)
    return _finish(nbrs, d)
