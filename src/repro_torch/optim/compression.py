"""Gradient compression for the data-parallel all-reduce (port of
``repro.optim.compression``): int8 with one scale per leaf and error
feedback (the quantization error carried to the next step), applied before
the reduction. ``torch.round`` rounds half to even, as ``jnp.round`` does.

Used by ``train.step.make_train_step(grad_compression="int8_ef")``.

On a mesh the gradients are blocks (``distributed/fsdp.py``) and the scale
is still the whole leaf's: under the reference's jit the step quantises the
global gradient, whatever its docstring says of a per-shard reduction. Each
leaf's block maximum goes through one pmax over the mesh (a copy of a block
on another rank has the same maximum).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpoint import flatten, unflatten


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, f32 scale): scale = max(max|x|, 1e-12) / 127,
    codes = clip(round(x / scale), -127, 127). ``amax``: the max |x| of the
    whole leaf when ``x`` is a block of it."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, residual, mesh=None):
    """Quantize grads + error feedback. Returns (q_tree, scales,
    new_residual). ``residual`` holds the previous step's quantization
    error (``None``: zeros); adding it back before quantizing makes the
    compression unbiased over time. The new residual is f32. On a mesh the
    leaves are blocks and each scale is its whole leaf's."""
    g_leaves = [g for _, g in flatten(grads)]
    r_leaves = [torch.zeros_like(g) for g in g_leaves] if residual is None else \
        [r for _, r in flatten(residual)]
    fed = [g.to(torch.float32) + r for g, r in zip(g_leaves, r_leaves)]
    amax = [None] * len(fed)
    if mesh is not None and fed:
        from repro_torch.distributed import comm
        vec = torch.stack([f.abs().max() if f.numel() else f.new_zeros(()) for f in fed])
        amax = list(comm.pmax(vec, mesh, mesh.axis_names).unbind(0))
    qs = [quantize_int8(f, a) for f, a in zip(fed, amax)]
    new_res = [f - dequantize_int8(q, s) for f, (q, s) in zip(fed, qs)]
    return (unflatten(grads, (q for q, _ in qs)), unflatten(grads, (s for _, s in qs)),
            unflatten(grads, iter(new_res)))


def decompress_tree(q, s):
    return unflatten(q, (dequantize_int8(a, b)
                         for (_, a), (_, b) in zip(flatten(q), flatten(s))))
