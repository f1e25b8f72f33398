from repro_torch.kernels.rng_prune.ops import (
    rng_prune,
    rng_prune_int8,
    rng_prune_int8_plain,
    rng_prune_plain,
)
from repro_torch.kernels.rng_prune.ref import rng_prune_ref

__all__ = ["rng_prune", "rng_prune_plain", "rng_prune_int8", "rng_prune_int8_plain",
           "rng_prune_ref"]
