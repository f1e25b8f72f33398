"""NN pieces of the recsys and LM models (port of ``repro.models.nn``):
parameters are plain dicts of tensors, the apply functions are plain
functions. No sharding axes: the port runs on one card.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device


def dense_init(generator: torch.Generator | None, d_in: int, d_out: int,
               device: str | torch.device = "cuda") -> dict:
    """``{"w": (d_in, d_out)}`` f32, N(0, 1) / sqrt(d_in), drawn from
    ``generator`` on ``device``."""
    w = torch.randn(d_in, d_out, generator=generator, device=resolve_device(device))
    return {"w": w / math.sqrt(d_in)}


def dense(params: dict, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """``x @ w`` with both operands cast to ``compute_dtype``; the product
    comes back in ``compute_dtype`` (one rounding of the f32-accumulated
    sum)."""
    return x.to(compute_dtype) @ params["w"].to(compute_dtype)


def mlp_init(generator: torch.Generator | None, dims: tuple[int, ...],
             device: str | torch.device = "cuda") -> dict:
    """Plain ReLU MLP (recsys towers). dims = (d_in, h1, ..., d_out):
    ``fc{i}`` as :func:`dense_init`, ``b{i}`` zeros (f32)."""
    dev = resolve_device(device)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"fc{i}"] = dense_init(generator, a, b, device=dev)
        params[f"b{i}"] = torch.zeros(b, device=dev)
    return params


def mlp(params: dict, x: torch.Tensor, n_layers: int,
        compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ReLU between layers. Each layer rounds the product to
    ``compute_dtype``, then adds the bias cast to ``compute_dtype`` (a second
    rounding), as the reference does."""
    for i in range(n_layers):
        x = dense(params[f"fc{i}"], x, compute_dtype) + params[f"b{i}"].to(compute_dtype)
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def rmsnorm_init(d: int, device: str | torch.device = "cuda") -> dict:
    return {"scale": torch.ones(d, device=resolve_device(device))}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` computed in f32, cast back to
    ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def embedding_init(generator: torch.Generator | None, vocab: int, d: int,
                   device: str | torch.device = "cuda") -> dict:
    """``{"table": (vocab, d)}`` f32, N(0, 1) * 0.02."""
    dev = resolve_device(device)
    return {"table": torch.randn(vocab, d, generator=generator, device=dev) * 0.02}


def embed(params: dict, ids: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """Rows ``ids`` of the table in ``compute_dtype``: gathered first, then
    cast (the bits of the reference's cast-then-gather, at the rows' cost;
    the gradient accumulates duplicate ids in the table's f32)."""
    return params["table"][ids.long()].to(compute_dtype)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(params.numel())
