"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package holds ``ref.py`` (the plain PyTorch version, the CPU path and the
on-card oracle) and ``ops.py`` (the wrapper: checks, allocation, launch).
A wrapper given CPU tensors calls the plain version; given CUDA tensors it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {"rng_prune": 0, "beam_score": 0, "pairwise_l2": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


METRIC_CODES = {"l2": 0, "ip": 1, "cos": 2}


def metric_code(metric: str) -> int:
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}: expected one of "
                         f"{tuple(METRIC_CODES)}")
    return METRIC_CODES[metric]
