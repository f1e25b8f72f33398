"""Plain PyTorch version of the FM second-order interaction."""
from __future__ import annotations

import torch


def fm_interact_ref(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B,) f32 ``0.5 * sum_d[(sum_f e)^2 - sum_f e^2]``, upcast
    to f32 first (Rendle's sum-square trick)."""
    e = emb.float()
    s = torch.sum(e, dim=1)
    ss = torch.sum(e * e, dim=1)
    return 0.5 * torch.sum(s * s - ss, dim=-1)
