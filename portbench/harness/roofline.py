"""Peaks of the card and the least time of a kernel's work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): HBM3 at 3.35 TB/s and 67 TFLOP/s of float32 outside the tensor
cores. A kernel's least time is the larger of its bytes over the memory
rate and its operations over the float32 rate: each input byte counted
read once and each output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def beam_score_work(expansions: float, lanes: float, valid_per_expansion: float,
                    k: int, d: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) of the ``beam_score`` launches that made
    ``expansions`` lane expansions over ``lanes`` lane slots in all (every
    launch's lanes, retired ones too). An expansion reads its frontier
    vertex's k prefix ids (4 bytes each) and its query (4 d bytes), and
    each valid candidate among the ids reads its row (``itemsize`` d bytes)
    for 4 d operations (l2: subtract, multiply, add, and the row's share of
    the reduction); every lane slot reads its frontier id (4 bytes) and
    writes k slots of id, distance and key (12 bytes each)."""
    cands = expansions * valid_per_expansion
    flops = cands * 4.0 * d
    nbytes = (cands * itemsize * d + expansions * (4.0 * k + 4.0 * d)
              + lanes * (4.0 + 12.0 * k))
    return flops, nbytes
