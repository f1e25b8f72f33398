"""FM second-order interaction: wrapper of ``csrc/fm_interact.cu``; its
plain version is :func:`fm_interact_ref`.

The gradient is the closed form ``dL/de[b, f, d] = g[b] * (sum_f' e[b, f', d]
- e[b, f, d])`` in plain tensor ops, computed in f32 and cast to the
embeddings' dtype (what ``jax.grad`` of the reference's ``fm_interact_ref``
gives): the reference has no backward kernel (its Pallas kernel does not
differentiate), so neither does the port."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels import spec as K
from repro_torch.kernels.fm_interact.ref import fm_interact_ref


def fm_interact(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) field embeddings, float32 or bfloat16 -> (B,) f32 FM
    second-order logit, accumulated in f32. CPU tensors run
    :func:`fm_interact_ref`; CUDA tensors the kernel; meta tensors give a
    meta output."""
    if emb.dim() != 3 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"emb must be (B, F, D) float32 or bfloat16, got "
                         f"{tuple(emb.shape)} {emb.dtype}")
    if emb.shape[1] == 0 or emb.shape[2] == 0:
        raise ValueError(f"emb needs F >= 1 and D >= 1, got {tuple(emb.shape)}")
    if emb.requires_grad and torch.is_grad_enabled():
        return _FMInteract.apply(emb)
    return _forward(emb)


def _forward(emb):
    """The forward route: the plain version for a CPU tensor, the kernel for
    a CUDA tensor; a meta tensor (the dry run) gets a (B,) meta output and
    launches nothing."""
    if emb.device.type == "cpu":
        return fm_interact_ref(emb)
    if emb.is_meta:
        return torch.empty((emb.shape[0],), dtype=torch.float32, device=emb.device)
    return _launch(emb)


def fm_backward(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The FM term's gradient: ``g[:, None, None] * (sum_f e - e)`` in f32,
    cast to ``emb.dtype``."""
    e = emb.float()
    return (g[:, None, None] * (e.sum(dim=1, keepdim=True) - e)).to(emb.dtype)


class _FMInteract(torch.autograd.Function):
    """:func:`fm_interact` with a gradient: the forward is the route of
    :func:`_forward` (one kernel launch on the card), the backward
    :func:`fm_backward` (a module global, looked up at call time, so a
    profiler range can wrap it)."""

    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return _forward(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return fm_backward(emb, g)


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


# ------------------------------------------------------------ launch shapes
_THREADS = 256     # csrc/fm_interact.cu: a block of 256, a 256-float partial sum


def kernel_spec(b: int, f: int, d: int, dtype: str = "f32", label: str = "") -> K.LaunchSpec:
    """The launch :func:`fm_interact` makes for (b, f, d): 256 / d rows a
    block (1 when d >= 256)."""
    rows = 1 if d >= _THREADS else _THREADS // d
    t = "__nv_bfloat16" if dtype == "bf16" else "float"
    return K.LaunchSpec(
        name=f"fm_interact[{dtype}]@{label or f'{b}x{f}x{d}'}", entry="fm_interact",
        source="fm_interact", instance=int(dtype == "bf16"),
        instance_name=f"fm_interact_kernel<{t}>", problem=(b, f, d, int(dtype == "bf16")),
        grid=(K.cdiv(b, rows), 1, 1), threads=_THREADS, static_smem=_THREADS * 4)


def default_specs() -> list[K.LaunchSpec]:
    """DeepFM's serve_bulk batch (262,144 x 39 x 10) in f32 and bf16, a
    width past one block, and the batch edge."""
    return [kernel_spec(262_144, 39, 10, "f32", "262144 x 39 x 10"),
            kernel_spec(262_144, 39, 10, "bf16", "262144 x 39 x 10"),
            kernel_spec(4_096, 39, 300, "f32", "4096 x 39 x 300"),
            kernel_spec(2**31 - 1, 2, 1, "f32", "b = 2^31 - 1 edge")]
