from repro_torch.kernels.fm_interact.ops import fm_interact
from repro_torch.kernels.fm_interact.ref import fm_interact_ref

__all__ = ["fm_interact", "fm_interact_ref"]
