"""Plain PyTorch oracle of the fused RNG prune over a gathered block."""
from __future__ import annotations

import torch

from repro_torch.core import distances as D
from repro_torch.core.rng import rng_scan


def rng_prune_ref(ids: torch.Tensor, dists: torch.Tensor, flags: torch.Tensor,
                  vecs: torch.Tensor, metric: str = "l2"):
    """ids/dists/flags (C, M) + gathered vecs (C, M, d) -> keep u8, red_w
    i32, red_d f32. The Gram is f32 whatever ``vecs``' dtype (bf16 gathers
    upcast first), formed exactly as ``batched_gram`` forms it."""
    pair = D.batched_gram(vecs.float(), metric)
    old = flags == 0
    res = rng_scan(ids, dists, pair, skip_pair=old[:, :, None] & old[:, None, :])
    return res.keep.to(torch.uint8), res.redirect_w, res.redirect_d
