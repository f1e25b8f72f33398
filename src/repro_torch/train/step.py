"""Generic train step builders (port of ``repro.train.step``): loss ->
gradients -> (int8 compression with error feedback) -> AdamW, with
microbatched gradient accumulation.

Gradients come from ``torch.autograd.grad`` over detached copies of the
parameter leaves (the parameters themselves never require grad), in the
reference's flatten order; a leaf the loss never reads gets a zero
gradient, as ``jax.grad`` gives it. The step updates the state in place
and returns it (the reference donates the state).

On a mesh (``mesh=``, with the state's and the batch's logical axes) the
state holds this rank's blocks (ZeRO-3, ``distributed/fsdp.py``), the step
takes the global batch and hands the loss this rank's block of it, and the
loss (``models/*.loss_fn(mesh=)``) returns the global loss with the
gradient of this rank's share, so the gradients come back as the global
gradients' blocks. Microbatch i is rows [i B/a, (i+1) B/a) of the global
batch, as the reference splits it, and each rank takes its block of those
rows.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.optim import adamw, compression


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    residual: Any            # error-feedback residual (None when off)


def init_state(params, use_compression: bool = False,
               compute_dtype: torch.dtype | None = None, mesh=None,
               param_axes=None) -> TrainState:
    """``compute_dtype``: store the ndim >= 3 leaves (the stacked layer
    matrices) in this dtype, with an f32 master of every leaf in the
    optimizer; norm scales, tables and heads stay f32. ``mesh``: ``params``
    are whole; the state keeps this rank's block of each (by
    ``param_axes``), and so do ``m``, ``v``, the master and the residual."""
    if mesh is not None:
        from repro_torch.distributed import sharding as sh
        params = sh.tree_local_blocks(params, mesh, param_axes)
    res = unflatten(params, (torch.zeros_like(p) for _, p in flatten(params))) \
        if use_compression else None
    if compute_dtype is not None:
        low = unflatten(params, (p.to(compute_dtype) if p.dim() >= 3 else p
                                 for _, p in flatten(params)))
        return TrainState(params=low, opt=adamw.init(low, keep_master=True), residual=res)
    return TrainState(params=params, opt=adamw.init(params), residual=res)


def value_and_grad(loss_fn: Callable, params, batch) -> tuple[torch.Tensor, Any]:
    """(loss, grads): ``grads`` has the parameters' structure and dtypes,
    zeros where the loss does not read a leaf."""
    leaves = [p for _, p in flatten(params)]
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(
    loss_fn: Callable,                     # (params, batch) -> scalar loss
    opt_cfg: adamw.AdamWConfig,
    grad_compression: str | None = None,   # None | "int8_ef"
    accum_steps: int = 1,
    mesh=None,
    param_axes=None,                       # with mesh: the params' logical axes
    batch_axes=None,                       # with mesh: the batch's logical axes
):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``loss``, ``lr`` and (with clipping) ``grad_norm`` as 0-dim tensors.
    With ``accum_steps`` > 1 the batch's leading dim is split into that many
    microbatches; their losses and f32 gradients are summed, then scaled by
    ``1 / accum_steps``. With ``mesh`` the state is this rank's blocks and
    ``batch`` the global batch (module docstring)."""
    if grad_compression not in (None, "int8_ef"):
        raise ValueError(f"grad_compression {grad_compression!r}")
    if mesh is not None and (param_axes is None or batch_axes is None):
        raise ValueError("a mesh train step needs param_axes and batch_axes")

    def local(batch):
        if mesh is None:
            return batch
        from repro_torch.distributed import sharding as sh
        return sh.tree_map_axes(lambda t, ax, name: sh.local_block(t, mesh, ax, name),
                                batch, batch_axes)

    def compute_grads(params, batch):
        if accum_steps == 1:
            return value_and_grad(loss_fn, params, local(batch))
        loss_acc = torch.zeros((), dtype=torch.float32)
        g_acc = None
        for i in range(accum_steps):
            mb = unflatten(batch, (_micro(x, accum_steps, i) for _, x in flatten(batch)))
            loss, g = value_and_grad(loss_fn, params, local(mb))
            loss_acc = loss_acc.to(loss.device) + loss
            g_leaves = [x for _, x in flatten(g)]
            g_acc = [x.to(torch.float32) for x in g_leaves] if g_acc is None else \
                [a + x for a, x in zip(g_acc, g_leaves)]
        inv = 1.0 / accum_steps
        return loss_acc * inv, unflatten(params, (x * inv for x in g_acc))

    def train_step(state: TrainState, batch):
        loss, grads = compute_grads(state.params, batch)
        residual = state.residual
        if grad_compression == "int8_ef":
            q, s, residual = compression.compress_tree(grads, residual, mesh)
            grads = compression.decompress_tree(q, s)
        params, opt, metrics = adamw.apply(opt_cfg, state.params, grads, state.opt,
                                           mesh, param_axes)
        metrics["loss"] = loss
        return TrainState(params, opt, residual), metrics

    return train_step


def _micro(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    if x.shape[0] % n:
        raise ValueError(f"batch dim {x.shape[0]} does not split into {n} microbatches")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]


def make_eval_step(loss_fn: Callable):
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return eval_step
