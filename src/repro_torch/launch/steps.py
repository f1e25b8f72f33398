"""Bind (arch, shape) -> the step the cell runs (port of
``repro.launch.steps``).

``bind`` returns, for every cell of the grid, the config, an init
function, the input shapes and the step function, all on one device:
``train`` cells (LM, GNN and recsys) a ``train.step`` train step over
``OPT_CFG`` whose init gives a ``TrainState`` (LM: layers in the compute
dtype with an f32 master; DimeNet and recsys: f32), LM ``prefill`` and
``decode`` cells the serving steps, recsys ``serve`` and ``retrieval`` and
the paper's ``ann_build`` and ``ann_search``.

``mesh=`` (a ``launch.mesh.Mesh`` this rank belongs to) binds every cell
over the mesh's ranks, as the reference binds it. ``init_fn`` gives this
rank's blocks of the state or params (``state_axes``: ZeRO-3 blocks for
the LM, row-sharded tables for recsys). A ``train`` step takes the global
batch and gives each rank its block (``batch_axes``); its loss is the
model's ``loss_fn(mesh=)``. A serving step (``prefill``, ``decode``,
``serve``, ``retrieval``) takes this rank's blocks of the batch and
returns this rank's blocks of its outputs (``out_axes``): the decode cache
is never whole on any rank (``sharding.tree_gather_blocks`` assembles a
global value). ``ann_build`` and ``ann_search`` take any mesh and ignore
it, as the reference does: their ``mesh`` is None and their steps are the
unmeshed ones. ``state_axes``, ``batch_axes`` and ``out_axes`` are the
reference's logical-axes trees, also without a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import base as cb
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.models import dimenet as dm
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train import step as tstep


@dataclasses.dataclass
class BoundStep:
    arch_id: str
    shape: ShapeSpec
    cfg: Any
    step_fn: Callable            # (state | params, batch) -> (state, metrics) | logits and
                                 # cache | scores | (top, idx) | graph | (ids, dists)
    init_fn: Callable            # (torch.Generator) -> state or params on the step's device
    input_specs: dict            # {name: (shape, dtype)}
    device: torch.device
    kind: str
    state_axes: Any = None       # logical-axes tree of the state (train: a TrainState)
    batch_axes: Any = None       # logical-axes tree of the batch
    mesh: Any = None
    out_axes: Any = None         # logical-axes tree of a serving step's outputs


OPT_CFG = adamw.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


def _train_state_axes(param_axes, master: bool = False) -> tstep.TrainState:
    """TrainState(params, OptState(step, m, v, master?), residual=None) axes."""
    return tstep.TrainState(
        params=param_axes,
        opt=adamw.OptState(step=(), m=param_axes, v=param_axes,
                           master=param_axes if master else None),
        residual=None)


def _lm_batch_axes(shape: ShapeSpec) -> dict:
    """The LM batch's logical axes (train, prefill, and decode at batch >= 16
    as the reference's ``_lm_batch_axes``)."""
    if shape.kind == "train":
        return {"tokens": ("batch", None), "labels": ("batch", None)}
    if shape.kind == "prefill":
        return {"tokens": ("batch", None)}
    if shape.dims["batch"] >= 16:
        return {"tokens": ("cache_batch",), "cache": tf.cache_axes()}
    return {"tokens": (None,), "cache": tf.cache_axes(flat=True)}


def _gnn_axes(key: str, ndim: int = 1) -> tuple:
    if key.startswith("edge_"):
        # chunked (C, ce): chunk axis replicated, 'data' on ce
        return (None, "edges") if ndim == 2 else ("edges",)
    table = {"node_feat": ("nodes", None), "pos": ("nodes", None),
             "triplet_kj": ("triplets",), "triplet_ji": ("triplets",),
             "triplet_mask": ("triplets",)}
    return table.get(key, (None,) * ndim)


def _train(arch_id, shape, cfg, loss, init_params, param_axes, specs, batch_axes, dev,
           mesh, compute_dtype=None) -> BoundStep:
    """A ``train`` cell: ``loss(params, batch, mesh)``, OPT_CFG, and on a mesh
    the blocks of the state."""
    state_axes = _train_state_axes(param_axes, master=compute_dtype is not None)
    train = tstep.make_train_step(
        lambda p, b: loss(p, b, mesh), OPT_CFG, mesh=mesh,
        param_axes=None if mesh is None else param_axes,
        batch_axes=None if mesh is None else batch_axes)

    def init_fn(gen):
        if mesh is None:
            return tstep.init_state(init_params(gen), compute_dtype=compute_dtype)
        return tstep.init_state(init_params(gen), compute_dtype=compute_dtype, mesh=mesh,
                                param_axes=param_axes)

    return BoundStep(arch_id, shape, cfg, train, init_fn, specs, dev, "train",
                     state_axes, batch_axes, mesh)


def bind_with_cfg(arch_id: str, shape_name: str, cfg,
                  device: str | torch.device = "cuda", mesh=None) -> BoundStep:
    """``bind`` with an explicit (overridden) model config, e.g. a depth
    cut to fit one card."""
    return bind(arch_id, shape_name, reduced=False, device=device, mesh=mesh, _cfg=cfg)


def bind(arch_id: str, shape_name: str, reduced: bool = False,
         device: str | torch.device = "cuda", mesh=None, _cfg=None) -> BoundStep:
    arch = configs.get(arch_id)
    shape = arch.shape(shape_name)
    cfg = _cfg if _cfg is not None else arch.make_config(shape_name, reduced)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if arch.family == "ann":
        return _bind_ann(arch, shape, cfg, reduced, dev)
    if arch.family == "lm":
        return _bind_lm(arch_id, shape, cfg, reduced, dev, mesh)
    if arch.family == "gnn":
        specs = cb.gnn_input_specs(cfg, shape, reduced)
        batch_axes = {k: _gnn_axes(k, len(s)) for k, (s, _) in specs.items()}
        return _train(arch_id, shape, cfg, lambda p, b, m: dm.loss_fn(p, b, cfg, mesh=m),
                      lambda gen: dm.init(gen, cfg, dev), dm.param_axes(cfg), specs,
                      batch_axes, dev, mesh)
    if arch.family != "recsys":
        raise ValueError(arch.family)
    specs = cb.recsys_input_specs(cfg, shape, reduced)

    if shape.kind == "retrieval":
        def retrieve_fn(params, batch):
            return rs.score_candidates(batch["query_emb"], batch["cand_embs"], k=100,
                                       mesh=mesh)

        return BoundStep(arch_id, shape, cfg, retrieve_fn, lambda gen: {}, specs, dev,
                         "retrieval", {}, {"query_emb": (None,), "cand_embs": ("candidates", None)},
                         mesh, ((None,), (None,)))
    batch_axes = {"sparse_ids": ("batch", None, None), "dense": ("batch", None)}
    if shape.kind == "train":
        batch_axes["labels"] = ("batch",)
        return _train(arch_id, shape, cfg, lambda p, b, m: rs.loss_fn(p, b, cfg, mesh=m),
                      lambda gen: rs.init(gen, cfg, dev), rs.param_axes(cfg), specs,
                      batch_axes, dev, mesh)

    def serve_fn(params, batch):
        return rs.serve(params, batch, cfg, mesh)

    return BoundStep(arch_id, shape, cfg, serve_fn,
                     _serving_init(lambda gen: rs.init(gen, cfg, dev), rs.param_axes(cfg), mesh),
                     specs, dev, "serve", rs.param_axes(cfg), batch_axes, mesh, ("batch",))


def _serving_init(init, axes, mesh):
    """A serving cell's init: the params, or on a mesh this rank's blocks."""
    if mesh is None:
        return init
    return lambda gen: sh.tree_local_blocks(init(gen), mesh, axes)


def _bind_lm(arch_id: str, shape: ShapeSpec, cfg, reduced: bool,
             dev: torch.device, mesh=None) -> BoundStep:
    """The LM cells: ``train`` (chunked CE + aux, ``OPT_CFG``, the train
    state's layers in ``cfg.compute_dtype`` with an f32 master),
    ``prefill`` (a fresh cache of the batch's length a call) and
    ``decode`` (one token against ``batch["cache"]``, written in place)."""
    specs = cb.lm_input_specs(cfg, shape, reduced)
    axes = _lm_batch_axes(shape)
    if shape.kind == "train":
        return _train(arch_id, shape, cfg, lambda p, b, m: tf.loss_fn(p, b, cfg, mesh=m),
                      lambda gen: tf.init(gen, cfg, dev), tf.param_axes(cfg), specs, axes,
                      dev, mesh, compute_dtype=cfg.compute_dtype)
    init = _serving_init(lambda gen: tf.init(gen, cfg, dev), tf.param_axes(cfg), mesh)
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            b, s = batch["tokens"].shape
            if mesh is not None:
                b *= sh.axis_count(mesh, "batch")
            cache = tf.init_cache(cfg, b, s, device=batch["tokens"].device, mesh=mesh)
            return tf.prefill(params, batch["tokens"], cache, cfg, mesh)

        return BoundStep(arch_id, shape, cfg, prefill_fn, init, specs, dev, "prefill",
                         tf.param_axes(cfg), axes, mesh,
                         (("batch", None, "vocab"), tf.cache_axes()))
    flat = axes["tokens"] == (None,)

    def decode_fn(params, batch):
        return tf.decode_step(params, batch["tokens"], batch["cache"], cfg, mesh, flat=flat)

    return BoundStep(arch_id, shape, cfg, decode_fn, init, specs, dev, "decode",
                     tf.param_axes(cfg), axes, mesh,
                     ((None if flat else "batch", None, "vocab"), axes["cache"]))


def _bind_ann(arch, shape: ShapeSpec, cfg, reduced: bool, dev: torch.device) -> BoundStep:
    """The paper's cells: ``ann_build`` (RNN-Descent; RandomGraph(S) drawn
    from ``batch["generator"]`` when the batch carries one, else from a
    generator seeded 0, as the reference draws from ``PRNGKey(0)``) and
    ``ann_search`` (``rnnd_ann.SEARCH`` over a graph given as neighbors and
    dists, all flags 0, from entry point 0). Reduced: n = 4096, d = 32, 128
    queries, ``SMOKE`` and ``SEARCH_SMOKE``."""
    from repro_torch.configs import rnnd_ann
    from repro_torch.core import graph as G
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as srch
    d = dict(shape.dims)
    n = d["n"] if not reduced else 4096
    dim = d["d"] if not reduced else 32
    if shape.kind == "ann_build":
        def build_fn(_params, batch):
            x = batch["x"]
            gen = batch.get("generator")
            if gen is None:
                gen = torch.Generator(device=x.device).manual_seed(0)
            return rd.build_jit(x, cfg, gen)

        return BoundStep(arch.arch_id, shape, cfg, build_fn, lambda gen: {},
                         {"x": ((n, dim), torch.float32)}, dev, "ann_build")
    nq = (-(-d["queries"] // 512) * 512) if not reduced else 128   # grid-divisible
    scfg = rnnd_ann.SEARCH_SMOKE if reduced else rnnd_ann.SEARCH
    cap = (rnnd_ann.SMOKE if reduced else rnnd_ann.FULL).capacity
    specs = {"x": ((n, dim), torch.float32), "neighbors": ((n, cap), torch.int32),
             "dists": ((n, cap), torch.float32), "queries": ((nq, dim), torch.float32)}

    def search_fn(_params, batch):
        nb = batch["neighbors"]
        g = G.Graph(nb, batch["dists"], torch.zeros_like(nb, dtype=torch.uint8))
        return srch.search(batch["x"], g, batch["queries"], 0, scfg)

    return BoundStep(arch.arch_id, shape, cfg, search_fn, lambda gen: {}, specs, dev,
                     "ann_search")
