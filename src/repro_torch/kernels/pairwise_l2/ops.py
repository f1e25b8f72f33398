"""Pairwise squared L2 distances: wrapper of ``csrc/pairwise_l2.cu``; its
plain version is :func:`pairwise_l2_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.pairwise_l2.ref import pairwise_l2_ref


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (na, d), b (nb, d), float32 or bfloat16 -> (na, nb) f32
    ``max(||a||^2 + ||b||^2 - 2ab, 0)`` with f32 accumulation. CPU tensors
    run :func:`pairwise_l2_ref`; CUDA tensors the kernel."""
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 2 or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be 2-D float32 or bfloat16, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if a.shape[1] != b.shape[1] or a.dtype != b.dtype or a.device != b.device:
        raise ValueError("a and b must share width, dtype and device")
    if a.device.type == "cpu":
        return pairwise_l2_ref(a, b)
    return _launch(a, b)


def _launch(a, b):
    na, d = a.shape
    nb = b.shape[0]
    if max(na, nb) >= 2**31:
        raise ValueError("na and nb must fit int32")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((na, nb), dtype=torch.float32, device=a.device)
    if na == 0 or nb == 0:
        return out
    rc = _build.load("pairwise_l2", "ppiiiipp")(
        a.data_ptr(), b.data_ptr(), na, nb, d, int(a.dtype == torch.bfloat16),
        out.data_ptr(), _build.stream_handle(a.device))
    _build.check(rc, "pairwise_l2")
    LAUNCHES["pairwise_l2"] += 1
    return out
