"""Pairwise squared L2 distances: wrapper of ``csrc/pairwise_l2.cu``; its
plain version is :func:`pairwise_l2_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels import spec as K
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


# ------------------------------------------------------------ launch shapes
# csrc/pairwise_l2.cu: a 256-thread block a 128 x 128 tile of the output,
# two (16, 132) f32 operand tiles and two 128-float norm vectors in static
# shared memory; nb along x, na along y.
_BM = _BN = 128
_STATIC = 2 * 16 * 132 * 4 + 2 * 128 * 4


def kernel_spec(na: int, nb: int, d: int, dtype: str = "f32", label: str = "") -> K.LaunchSpec:
    """The launch :func:`pairwise_l2` makes for a (na, d) x (nb, d) problem."""
    t = "__nv_bfloat16" if dtype == "bf16" else "float"
    return K.LaunchSpec(
        name=f"pairwise_l2[{dtype}]@{label or f'{na}x{nb}x{d}'}", entry="pairwise_l2",
        source="pairwise_l2", instance=int(dtype == "bf16"),
        instance_name=f"pairwise_l2_kernel<{t}>", problem=(na, nb, d, int(dtype == "bf16")),
        grid=(K.cdiv(nb, _BN), K.cdiv(na, _BM), 1), threads=256, static_smem=_STATIC)


def default_specs() -> list[K.LaunchSpec]:
    """Ground truth's 1,024 queries x 1M x 128 and 1,000 x 1M x 960 (f32,
    and bf16 at d = 128), and the largest na the launch takes."""
    return [kernel_spec(1_024, 1_000_000, 128, "f32", "1024 x 1M x 128"),
            kernel_spec(1_024, 1_000_000, 128, "bf16", "1024 x 1M x 128"),
            kernel_spec(1_000, 1_000_000, 960, "f32", "1000 x 1M x 960"),
            kernel_spec(65_535 * _BM, 1_000_000, 128, "f32", "na = 65535 x 128 edge")]
