"""FM second-order interaction: wrapper of ``csrc/fm_interact.cu``; its
plain version is :func:`fm_interact_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.fm_interact.ref import fm_interact_ref


def fm_interact(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) field embeddings, float32 or bfloat16 -> (B,) f32 FM
    second-order logit, accumulated in f32. CPU tensors run
    :func:`fm_interact_ref`; CUDA tensors the kernel."""
    if emb.dim() != 3 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"emb must be (B, F, D) float32 or bfloat16, got "
                         f"{tuple(emb.shape)} {emb.dtype}")
    if emb.shape[1] == 0 or emb.shape[2] == 0:
        raise ValueError(f"emb needs F >= 1 and D >= 1, got {tuple(emb.shape)}")
    if emb.device.type == "cpu":
        return fm_interact_ref(emb)
    return _launch(emb)


def _launch(emb):
    b, f, d = emb.shape
    if b >= 2**31 or f * d >= 2**31:
        raise ValueError("B and F * D must fit int32")
    out = torch.empty((b,), dtype=torch.float32, device=emb.device)
    if b == 0:
        return out
    emb = emb.contiguous()
    rc = _build.load("fm_interact", "piiiipp")(
        emb.data_ptr(), b, f, d, int(emb.dtype == torch.bfloat16), out.data_ptr(),
        _build.stream_handle(emb.device))
    _build.check(rc, "fm_interact")
    LAUNCHES["fm_interact"] += 1
    return out
