"""Fused beam expansion (gather adjacency prefix, gather rows, score):
wrappers of ``csrc/beam_score.cu`` (f32/bf16 rows, int8 code rows) and
``csrc/beam_score_pq.cu`` (PQ codes against per-query tables); their plain
versions are in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build, metric_code
from repro_torch.kernels import spec as K
from repro_torch.kernels.beam_score.ref import (
    beam_score_int8_ref,
    beam_score_pq_ref,
    beam_score_ref,
)


def _check_rows(x, neighbors, u, dtypes, *rest):
    if x.dim() != 2 or x.dtype not in dtypes:
        raise ValueError(f"x must be (n, d) of {dtypes}, got {tuple(x.shape)} {x.dtype}")
    if neighbors.dim() != 2 or neighbors.dtype != torch.int32 \
            or neighbors.shape[0] != x.shape[0]:
        raise ValueError("neighbors must be (n, M) int32 over the rows of x")
    if u.dim() != 1 or u.dtype != torch.int32:
        raise ValueError(f"u must be (B,) int32, got {tuple(u.shape)} {u.dtype}")
    devs = {t.device for t in (x, neighbors, u, *rest)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must share one device, got {devs}")


def _check_f32(name, t, shape):
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be {tuple(shape)} float32, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check(x, neighbors, u, queries):
    _check_rows(x, neighbors, u, (torch.float32, torch.bfloat16), queries)
    _check_f32("queries", queries, (u.shape[0], x.shape[1]))


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


def _outputs(x, neighbors, u, k):
    """(ids i32, dists f32, keys i32), each (B, min(k, M)): views of one
    allocation (a torch.empty costs about 4.5 us of host time on an H100
    80GB HBM3 host, scripts/beam_ab.py)."""
    if x.shape[0] >= 2**31:
        raise ValueError("n must fit int32")
    b, k = u.shape[0], max(0, min(k, neighbors.shape[1]))
    ids, dists, keys = torch.empty((3, b, k), dtype=torch.int32, device=x.device).unbind(0)
    return ids, dists.view(torch.float32), keys


def _launch(x, neighbors, u, queries, k, metric):
    ids, dists, keys = _outputs(x, neighbors, u, k)
    if ids.numel() == 0:
        return ids, dists, keys
    (n, d), m, (b, k) = x.shape, neighbors.shape[1], ids.shape
    x, neighbors, u, queries = (t.contiguous() for t in (x, neighbors, u, queries))
    rc = _build.load("beam_score", "ppppiiiiiiipppp")(
        x.data_ptr(), neighbors.data_ptr(), u.data_ptr(), queries.data_ptr(),
        n, d, m, b, k, metric_code(metric), int(x.dtype == torch.bfloat16),
        ids.data_ptr(), dists.data_ptr(), keys.data_ptr(),
        _build.stream_handle(x.device))
    _build.check(rc, "beam_score")
    LAUNCHES["beam_score"] += 1
    return ids, dists, keys


def beam_score_int8(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    neighbors: torch.Tensor, u: torch.Tensor, queries: torch.Tensor,
                    k: int, metric: str = "l2"):
    """:func:`beam_score` over an int8 corpus ``codes`` (n, d) with per-dim
    ``scale``/``zero`` (d,): the gathered code rows are decoded in registers
    (``codes * scale + zero``, two roundings) and scored as f32 rows. CPU
    tensors run :func:`beam_score_int8_ref`; CUDA tensors the kernel."""
    metric_code(metric)
    _check_rows(codes, neighbors, u, (torch.int8,), scale, zero, queries)
    d = codes.shape[1]
    _check_f32("scale", scale, (d,))
    _check_f32("zero", zero, (d,))
    _check_f32("queries", queries, (u.shape[0], d))
    if codes.device.type == "cpu":
        return beam_score_int8_ref(codes, scale, zero, neighbors, u, queries, k, metric)
    ids, dists, keys = _outputs(codes, neighbors, u, k)
    if ids.numel() == 0:
        return ids, dists, keys
    n, m, (b, k) = codes.shape[0], neighbors.shape[1], ids.shape
    codes, scale, zero, neighbors, u, queries = (
        t.contiguous() for t in (codes, scale, zero, neighbors, u, queries))
    rc = _build.load("beam_score_int8", "ppppppiiiiiipppp", source="beam_score")(
        codes.data_ptr(), scale.data_ptr(), zero.data_ptr(), neighbors.data_ptr(),
        u.data_ptr(), queries.data_ptr(), n, d, m, b, k, metric_code(metric),
        ids.data_ptr(), dists.data_ptr(), keys.data_ptr(),
        _build.stream_handle(codes.device))
    _build.check(rc, "beam_score_int8")
    LAUNCHES["beam_score_int8"] += 1
    return ids, dists, keys


def beam_score_pq(codes: torch.Tensor, neighbors: torch.Tensor, u: torch.Tensor,
                  lut_a: torch.Tensor, lut_b: torch.Tensor, qsq: torch.Tensor,
                  k: int, metric: str = "l2"):
    """:func:`beam_score` over PQ codes (n, m) uint8, scored against the
    per-query tables of ``pq_lut``: ``lut_a`` (B, m, 256), ``lut_b``
    (m, 256), ``qsq`` (B,). CPU tensors run :func:`beam_score_pq_ref`;
    CUDA tensors the kernel."""
    metric_code(metric)
    _check_rows(codes, neighbors, u, (torch.uint8,), lut_a, lut_b, qsq)
    b, mq = u.shape[0], codes.shape[1]
    _check_f32("lut_a", lut_a, (b, mq, 256))
    _check_f32("lut_b", lut_b, (mq, 256))
    _check_f32("qsq", qsq, (b,))
    if codes.device.type == "cpu":
        return beam_score_pq_ref(codes, neighbors, u, lut_a, lut_b, qsq, k, metric)
    ids, dists, keys = _outputs(codes, neighbors, u, k)
    if ids.numel() == 0:
        return ids, dists, keys
    n, m, k = codes.shape[0], neighbors.shape[1], ids.shape[1]
    codes, neighbors, u, lut_a, lut_b, qsq = (
        t.contiguous() for t in (codes, neighbors, u, lut_a, lut_b, qsq))
    rc = _build.load("beam_score_pq", "ppppppiiiiiipppp")(
        codes.data_ptr(), neighbors.data_ptr(), u.data_ptr(), lut_a.data_ptr(),
        lut_b.data_ptr(), qsq.data_ptr(), n, mq, m, b, k, metric_code(metric),
        ids.data_ptr(), dists.data_ptr(), keys.data_ptr(),
        _build.stream_handle(codes.device))
    _build.check(rc, "beam_score_pq")
    LAUNCHES["beam_score_pq"] += 1
    return ids, dists, keys


# ------------------------------------------------------------ launch shapes
# csrc/beam_score.cu: a block of 4 warps a lane for f32/bf16 rows, 4 lanes (a
# warp each) a block for int8 and PQ codes; each holds two (4, 128) int
# windows of compacted ids and slots in static shared memory.
_WARPS, _WIN = 4, 128
_STATIC = 2 * _WARPS * _WIN * 4
# (G, PPT) of the rows instances by index: f32 0-6, bf16 7-12
_ROWS = ((0, 1), (8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (32, 8))
_BF16_BASE, _INT8_BASE = 7, 13
_GROUPS = (0, 1, 2, 4, 8, 16, 32)     # G of the int8 and PQ instances


def _rows_index(d: int, bf16: bool, aligned: bool) -> int:
    e = 8 if bf16 else 4
    pieces = d // e if d % e == 0 and d <= 1024 and aligned else 0
    for i, top in enumerate((4, 8, 16, 32, 64)):
        if pieces <= top:
            return i
    return 6 if not bf16 and pieces > 128 else 5


def _group_index(pieces: int) -> int:
    if pieces == 0 or pieces > 32:
        return 0
    return next(i for i, g in enumerate(_GROUPS) if g and pieces <= g)


def kernel_spec(entry: str, d: int, b: int, dtype: str = "f32", aligned: bool = True,
                label: str = "") -> K.LaunchSpec:
    """The launch ``entry`` ("beam_score", "beam_score_int8" or
    "beam_score_pq") makes for ``b`` lanes over rows of width ``d`` (PQ: ``d``
    code bytes a row, the subspaces m); ``dtype`` "f32"/"bf16" picks
    beam_score's row type; ``aligned``: the corpus (codes) 16-byte aligned.
    No dynamic shared memory, no attributes; the residency claimed is
    ``__launch_bounds__``' minimum."""
    lab = label or f"b={b},d={d}"
    if entry == "beam_score":
        bf16 = dtype == "bf16"
        i = _rows_index(d, bf16, aligned)
        g, ppt = _ROWS[i]
        t = "__nv_bfloat16" if bf16 else "float"
        return K.LaunchSpec(
            name=f"beam_score[{dtype},G={g},PPT={ppt}]@{lab}", entry=entry,
            source="beam_score", instance=i + (_BF16_BASE if bf16 else 0),
            instance_name=f"beam_score_kernel<{t}, {g}, {ppt}>",
            problem=(d, b, int(bf16), int(aligned)), grid=(b, 1, 1), threads=32 * _WARPS,
            static_smem=_STATIC, blocks_per_sm=8 if ppt == 1 else 2 if ppt >= 8 else 4)
    if entry == "beam_score_int8":
        pieces = d // 16 if d % 16 == 0 and aligned else 0
        j = _group_index(pieces)
        return K.LaunchSpec(
            name=f"beam_score_int8[G={_GROUPS[j]}]@{lab}", entry=entry, source="beam_score",
            instance=_INT8_BASE + j, instance_name=f"beam_score_int8_kernel<{_GROUPS[j]}>",
            problem=(d, b, int(aligned)), grid=(K.cdiv(b, _WARPS), 1, 1),
            threads=32 * _WARPS, static_smem=_STATIC, blocks_per_sm=4)
    if entry == "beam_score_pq":
        j = _group_index(K.cdiv(d, 8))
        return K.LaunchSpec(
            name=f"beam_score_pq[G={_GROUPS[j]}]@{lab}", entry=entry, source="beam_score_pq",
            instance=j, instance_name=f"beam_score_pq_kernel<{_GROUPS[j]}>",
            problem=(d, b), grid=(K.cdiv(b, _WARPS), 1, 1), threads=32 * _WARPS,
            static_smem=_STATIC, blocks_per_sm=4)
    raise ValueError(f"unknown beam entry {entry!r}")


def default_specs() -> list[K.LaunchSpec]:
    """The search's beams of 10,240 lanes at d = 128 and 960, f32 and bf16,
    int8 and PQ (m = 32) at 1M; widths that pick every other instance; an
    unaligned corpus; the lane-count edge."""
    b = 10_240
    out = [kernel_spec("beam_score", d, b, dt, label=f"{b} lanes, d={d}")
           for d in (128, 960) for dt in ("f32", "bf16")]
    out += [kernel_spec("beam_score", d, b, "f32") for d in (16, 32, 64, 256, 512)]
    out += [kernel_spec("beam_score", d, b, "bf16") for d in (32, 64, 256, 512)]
    out.append(kernel_spec("beam_score", 128, b, "f32", aligned=False,
                           label=f"{b} lanes, d=128, unaligned"))
    out.append(kernel_spec("beam_score", 128, 2**31 - 1, "f32", label="lanes = 2^31 - 1 edge"))
    out += [kernel_spec("beam_score_int8", d, b, label=f"{b} lanes, d={d}")
            for d in (8, 16, 32, 64, 128, 256, 512, 960)]
    out += [kernel_spec("beam_score_pq", m, b, label=f"{b} lanes, m={m}")
            for m in (8, 16, 32, 64, 128, 256, 264)]
    out.append(kernel_spec("beam_score_pq", 32, 2**31 - 1, label="lanes = 2^31 - 1 edge"))
    return out
