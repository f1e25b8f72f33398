"""Plain PyTorch version of the pairwise squared-L2 tile."""
from __future__ import annotations

import torch


def pairwise_l2_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max(||a||^2 + ||b||^2 - 2 a b^T, 0)`` in f32, (na, nb)."""
    a = a.float()
    b = b.float()
    an = torch.sum(a * a, dim=-1)[:, None]
    bn = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(an + bn - 2.0 * (a @ b.T), min=0.0)
