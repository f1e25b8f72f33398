from repro_torch.kernels.pairwise_l2.ops import pairwise_l2
from repro_torch.kernels.pairwise_l2.ref import pairwise_l2_ref

__all__ = ["pairwise_l2", "pairwise_l2_ref"]
