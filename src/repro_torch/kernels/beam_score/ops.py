"""Fused beam expansion (gather adjacency prefix, gather vectors, score):
wrapper of ``csrc/beam_score.cu``; its plain version is :func:`beam_score_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build, metric_code
from repro_torch.kernels.beam_score.ref import beam_score_ref


def _check(x, neighbors, u, queries):
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (n, d) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if neighbors.dim() != 2 or neighbors.dtype != torch.int32 \
            or neighbors.shape[0] != x.shape[0]:
        raise ValueError("neighbors must be (n, M) int32 over the rows of x")
    if u.dim() != 1 or u.dtype != torch.int32:
        raise ValueError(f"u must be (B,) int32, got {tuple(u.shape)} {u.dtype}")
    if queries.shape != (u.shape[0], x.shape[1]) or queries.dtype != torch.float32:
        raise ValueError(f"queries must be (B, d) = ({u.shape[0]}, {x.shape[1]}) "
                         f"float32, got {tuple(queries.shape)} {queries.dtype}")
    devs = {t.device for t in (x, neighbors, u, queries)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")


def beam_score(x: torch.Tensor, neighbors: torch.Tensor, u: torch.Tensor,
               queries: torch.Tensor, k: int, metric: str = "l2"):
    """Returns (ids i32, dists f32, keys i32), each (B, min(k, M)): lane b's
    first k neighbours of ``u[b]`` (-1 / +inf for padded slots) and their
    distances to ``queries[b]``; ``dists`` decodes exactly from ``keys``.
    CPU tensors run :func:`beam_score_ref`; CUDA tensors the kernel, which
    reads an id outside [0, n) as padding instead of faulting."""
    metric_code(metric)
    _check(x, neighbors, u, queries)
    if x.device.type == "cpu":
        return beam_score_ref(x, neighbors, u, queries, k, metric)
    return _launch(x, neighbors, u, queries, k, metric)


def _launch(x, neighbors, u, queries, k, metric):
    n, d = x.shape
    m = neighbors.shape[1]
    b = u.shape[0]
    k = max(0, min(k, m))
    if n >= 2**31:
        raise ValueError("n must fit int32")
    x, neighbors, u, queries = (t.contiguous() for t in (x, neighbors, u, queries))
    ids = torch.empty((b, k), dtype=torch.int32, device=x.device)
    dists = torch.empty((b, k), dtype=torch.float32, device=x.device)
    keys = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b == 0 or k == 0:
        return ids, dists, keys
    rc = _build.load("beam_score", "ppppiiiiiiipppp")(
        x.data_ptr(), neighbors.data_ptr(), u.data_ptr(), queries.data_ptr(),
        n, d, m, b, k, metric_code(metric), int(x.dtype == torch.bfloat16),
        ids.data_ptr(), dists.data_ptr(), keys.data_ptr(),
        _build.stream_handle(x.device))
    _build.check(rc, "beam_score")
    LAUNCHES["beam_score"] += 1
    return ids, dists, keys
