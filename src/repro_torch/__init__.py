"""PyTorch/CUDA port of the RNN-Descent graph-ANN package (``repro``).

The port mirrors ``repro``'s layout module by module. Plain tensor code is
PyTorch; every Pallas kernel of the reference (fused RNG prune, fused beam
gather+score, pairwise L2, their int8/PQ variants, the FM interaction of the
recsys models) is a hand-written CUDA C++ kernel for Hopper
(``repro_torch/kernels/csrc``), built with ``nvcc`` at first use.

Device rules:
  * functions that take tensors run on the device those tensors live on; a
    kernel wrapper given a CPU tensor runs the kernel's plain PyTorch version,
    given a CUDA tensor it launches the kernel or raises;
  * entry points that place data (``clustered_vectors``, ``graph_from_numpy``,
    ``build``/``search_tiled`` on numpy input) default to ``device="cuda"``
    and raise when no CUDA device is present.

f32 paths stay in full f32: TF32 is switched off for matmuls and cuDNN.
bf16 products accumulate in f32 throughout (no reduced-precision split-K
reductions), as the reference's do.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device) -> torch.device:
    """Normalise ``device``; a CUDA device without CUDA raises (the port
    never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device=\"cpu\" to run the plain PyTorch versions")
    return dev


def as_tensor(a, device: str | torch.device = "cuda",
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Tensors pass through (their device decides); anything else (numpy,
    lists) is placed on ``device``, which must exist."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))
