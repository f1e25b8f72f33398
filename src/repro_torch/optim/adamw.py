"""AdamW + LR schedules + global-norm clipping (port of
``repro.optim.adamw``): the reference's own formula, not
``torch.optim.AdamW`` (which orders the decay and the update differently
and keeps no f32 master).

Optimizer state mirrors the parameter tree: ``m``, ``v`` and the optional
f32 ``master`` have one f32 leaf per parameter. Trees are nested dicts (or
NamedTuples, lists) of tensors, walked in the reference's flatten order
(``checkpoint.flatten``). ``apply`` updates the state and the parameters
in place (the reference donates them); elementwise updates run over row
blocks of at most ``_BLOCK`` elements, which bounds their temporaries
without changing a value.

On a mesh (``mesh=`` with the parameters' logical ``axes``) every leaf is
this rank's block (``distributed/fsdp.py``): the update is elementwise, so
it runs on the blocks as they are; only the global norm of the clipping
reads the whole tree (:func:`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.checkpoint import flatten, unflatten

_BLOCK = 1 << 26      # elements an elementwise pass touches at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # cosine | linear | constant


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    m: Any
    v: Any
    master: Any = None           # f32 master copy when params are low-precision


def _map(fn, tree):
    return unflatten(tree, (fn(leaf) for _, leaf in flatten(tree)))


def init(params, keep_master: bool = False) -> OptState:
    """Zero moments (f32, one per leaf) and, with ``keep_master``, an f32
    copy of every parameter (its own storage, also for an f32 leaf)."""
    leaves = [p for _, p in flatten(params)]
    if not leaves:
        raise ValueError("params has no leaves")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = _map(lambda p: p.detach().to(torch.float32, copy=True), params) \
        if keep_master else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                    m=_map(zeros, params), v=_map(zeros, params), master=master)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32: linear warmup to
    ``cfg.lr`` over ``warmup_steps``, then cosine, linear or constant over
    the rest of ``total_steps``."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = torch.ones_like(t)
    return cfg.lr * warm * decay


def _blocks(t: torch.Tensor):
    """Row blocks of ``t`` (views) of at most ``_BLOCK`` elements each."""
    if t.dim() == 0 or t.numel() <= _BLOCK:
        yield t
        return
    rows = max(1, _BLOCK // max(1, t[0].numel()))
    yield from t.split(rows, dim=0)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x^2) of one leaf in f32."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in _blocks(x):
        f = blk.reshape(-1).to(torch.float32)
        total = total + torch.dot(f, f)
    return total


def global_norm(tree, mesh=None, axes=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, leaves summed in flatten
    order in f32. On a mesh (``tree``'s leaves are blocks placed by the
    logical ``axes``, a list in flatten order or a tree) each leaf's square
    sum is its blocks' sum over the ranks, counted once: a rank whose index
    along the leaf's replicated axes is not 0 adds nothing, and one psum
    over the mesh sums the vector of leaves."""
    leaves = [x for _, x in flatten(tree)]
    sq = [_sq_sum(x) for x in leaves]
    if mesh is not None:
        from repro_torch.distributed import comm
        from repro_torch.distributed import sharding as sh
        axes = axes if isinstance(axes, list) else sh.leaf_axes(axes, tree)
        own = [sh.index_along(mesh, sh.replicated_axes(mesh, ax)) == 0 for ax in axes]
        vec = torch.stack([s if o else torch.zeros_like(s) for s, o in zip(sq, own)])
        sq = list(comm.psum(vec, mesh, mesh.axis_names).unbind(0))
    total = None
    for s in sq:
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, mesh=None, axes=None):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-9))`` (in the
    leaf's dtype). Returns (clipped grads, norm); the grads are scaled in
    place."""
    norm = global_norm(grads, mesh, axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for _, g in flatten(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def apply(cfg: AdamWConfig, params, grads, state: OptState, mesh=None, axes=None):
    """One AdamW step. Returns (params, state, metrics): the same parameter
    and moment tensors, updated in place. ``grads`` has the parameters'
    structure (a leaf the loss never read carries zeros: ``train.step``
    gives them, so weight decay still moves that leaf, as in the
    reference); its leaves are clipped in place. On a mesh, ``axes`` is
    the parameters' logical-axes tree and every leaf a block."""
    pairs = flatten(params)
    p_leaves = [p for _, p in pairs]
    g_leaves = [g for _, g in flatten(grads)]
    if len(g_leaves) != len(p_leaves):
        raise ValueError(f"grads has {len(g_leaves)} leaves, params {len(p_leaves)}")
    for (name, p), g in zip(pairs, g_leaves):
        if g.shape != p.shape:
            raise ValueError(f"gradient {name}: shape {tuple(g.shape)}, expected {tuple(p.shape)}")
    metrics = {}
    if cfg.clip_norm is not None:
        leaf_axes = None
        if mesh is not None:
            from repro_torch.distributed import sharding as sh
            leaf_axes = sh.leaf_axes(axes, params)
        _, gnorm = clip_by_global_norm(g_leaves, cfg.clip_norm, mesh, leaf_axes)
        metrics["grad_norm"] = gnorm
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    metrics["lr"] = lr
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, sf)
    b2c = 1.0 - torch.pow(cfg.b2, sf)
    m_leaves = [m for _, m in flatten(state.m)]
    v_leaves = [v for _, v in flatten(state.v)]
    masters = [w for _, w in flatten(state.master)] if state.master is not None else p_leaves
    with torch.no_grad():
        for p, g, m, v, w in zip(p_leaves, g_leaves, m_leaves, v_leaves, masters):
            for pb, gb, mb, vb, wb in zip(*(_blocks(t) for t in (p, g, m, v, w))):
                gf = gb.to(torch.float32)
                mb.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
                vb.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
                ref = wb.to(torch.float32)
                upd = (mb / b1c) / (torch.sqrt(vb / b2c) + cfg.eps) + cfg.weight_decay * ref
                new = ref - lr * upd
                if state.master is not None:
                    wb.copy_(new)
                pb.copy_(new)
    return params, OptState(step, state.m, state.v, state.master), metrics
