"""ZeRO-3 storage over a mesh of ranks: the counterpart of the reference's
``fsdp`` axes, which XLA's partitioner turns into just-in-time gathers.

Each rank holds every leaf of the train state (params, AdamW's ``m`` and
``v``, the f32 ``master``) as its block of the leaf's logical axes
(``sharding.local_block``). A model on a mesh reads a leaf through
:func:`use`, inside the layer that needs it (so remat's recompute gathers
it again): the leaf is all-gathered over the axes it is split over, and its
gradient comes back to the block, reduce-scattered over those axes and
summed over the axes where the rank holds a copy.

The gradient is the sum over the ranks of what each rank differentiates.
So each rank differentiates its share of the objective (:func:`objective`):
the terms it computes alone, plus the terms that every rank of a group
computes alike divided by the group's size (:func:`replication`). Ranks
that split the work (the LM's tokens over data and model; recsys' batch and
DimeNet's edges over data) add up; ranks that repeat it (recsys and DimeNet
over ``model``) count once between them, so no gradient is counted twice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import comm
from repro_torch.distributed import sharding as sh


class _Replicated(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``axes``."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return comm.psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


def use(block: torch.Tensor, mesh, logical_axes, over=None) -> torch.Tensor:
    """The leaf to compute with, from this rank's block: gathered over the
    mesh axes it is split over (only those in ``over`` when given: the
    shard-mapped MoE keeps its experts split over ``model``). Backward: the
    gradient reduce-scattered over the gathered axes and summed over the
    axes the leaf is replicated on."""
    if block.requires_grad and torch.is_grad_enabled() and replication(mesh, logical_axes) > 1:
        block = _Replicated.apply(block, mesh, sh.replicated_axes(mesh, logical_axes))
    return sh.gather_block(block, mesh, logical_axes, over=over)


def replication(mesh, logical_axes) -> int:
    """How many ranks compute the same thing for data placed by
    ``logical_axes`` (e.g. ``("batch",)``: the model axis' size)."""
    return math.prod(mesh.shape[a] for a in sh.replicated_axes(mesh, logical_axes))


class _Objective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share, value):
        return value.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def objective(value: torch.Tensor, share: torch.Tensor) -> torch.Tensor:
    """A scalar whose value is ``value`` (the global loss, the same on every
    rank) and whose gradient is that of ``share`` (this rank's part of it)."""
    return _Objective.apply(share, value)


def state_bytes(tree) -> int:
    """Bytes of the tensors in a (nested) state, each storage once."""
    from repro_torch.checkpoint.checkpoint import flatten
    seen, total = set(), 0
    for _, t in flatten(tree):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total
