"""Bind (arch, shape) -> the step the cell runs (port of
``repro.launch.steps``).

``bind`` returns, for every cell of the grid, the config, an init
function, the input shapes and the step function, all on one device:
``train`` cells (LM, GNN and recsys) a ``train.step`` train step over
``OPT_CFG`` whose init gives a ``TrainState`` (LM: layers in the compute
dtype with an f32 master; DimeNet and recsys: f32), LM ``prefill`` and
``decode`` cells the serving steps, recsys ``serve`` and ``retrieval`` and
the paper's ``ann_build`` and ``ann_search``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import base as cb
from repro_torch.configs.base import ShapeSpec
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


OPT_CFG = adamw.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


def bind_with_cfg(arch_id: str, shape_name: str, cfg,
                  device: str | torch.device = "cuda") -> BoundStep:
    """``bind`` with an explicit (overridden) model config, e.g. a depth
    cut to fit one card."""
    return bind(arch_id, shape_name, reduced=False, device=device, _cfg=cfg)


def bind(arch_id: str, shape_name: str, reduced: bool = False,
         device: str | torch.device = "cuda", _cfg=None) -> BoundStep:
    arch = configs.get(arch_id)
    shape = arch.shape(shape_name)
    cfg = _cfg if _cfg is not None else arch.make_config(shape_name, reduced)
    dev = resolve_device(device)
    if arch.family == "ann":
        return _bind_ann(arch, shape, cfg, reduced, dev)
    if arch.family == "lm":
        return _bind_lm(arch_id, shape, cfg, reduced, dev)
    if arch.family == "gnn":
        train = tstep.make_train_step(lambda p, b: dm.loss_fn(p, b, cfg), OPT_CFG)
        return BoundStep(arch_id, shape, cfg, train,
                         lambda gen: tstep.init_state(dm.init(gen, cfg, dev)),
                         cb.gnn_input_specs(cfg, shape, reduced), dev, "train")
    if arch.family != "recsys":
        raise ValueError(arch.family)
    specs = cb.recsys_input_specs(cfg, shape, reduced)

    if shape.kind == "retrieval":
        def retrieve_fn(params, batch):
            return rs.score_candidates(batch["query_emb"], batch["cand_embs"], k=100)

        return BoundStep(arch_id, shape, cfg, retrieve_fn, lambda gen: {}, specs, dev,
                         "retrieval")
    if shape.kind == "train":
        train = tstep.make_train_step(lambda p, b: rs.loss_fn(p, b, cfg), OPT_CFG)
        return BoundStep(arch_id, shape, cfg, train,
                         lambda gen: tstep.init_state(rs.init(gen, cfg, dev)), specs, dev,
                         "train")

    def serve_fn(params, batch):
        return rs.serve(params, batch, cfg)

    return BoundStep(arch_id, shape, cfg, serve_fn, lambda gen: rs.init(gen, cfg, dev),
                     specs, dev, "serve")


def _bind_lm(arch_id: str, shape: ShapeSpec, cfg, reduced: bool,
             dev: torch.device) -> BoundStep:
    """The LM cells: ``train`` (chunked CE + aux, ``OPT_CFG``, the train
    state's layers in ``cfg.compute_dtype`` with an f32 master),
    ``prefill`` (a fresh cache of the batch's length a call) and
    ``decode`` (one token against ``batch["cache"]``, written in place)."""
    specs = cb.lm_input_specs(cfg, shape, reduced)
    if shape.kind == "train":
        train = tstep.make_train_step(lambda p, b: tf.loss_fn(p, b, cfg), OPT_CFG)

        def init_fn(gen):
            return tstep.init_state(tf.init(gen, cfg, dev), compute_dtype=cfg.compute_dtype)

        return BoundStep(arch_id, shape, cfg, train, init_fn, specs, dev, "train")
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            b, s = batch["tokens"].shape
            cache = tf.init_cache(cfg, b, s, device=batch["tokens"].device)
            return tf.prefill(params, batch["tokens"], cache, cfg)

        return BoundStep(arch_id, shape, cfg, prefill_fn, lambda gen: tf.init(gen, cfg, dev),
                         specs, dev, "prefill")

    def decode_fn(params, batch):
        return tf.decode_step(params, batch["tokens"], batch["cache"], cfg)

    return BoundStep(arch_id, shape, cfg, decode_fn, lambda gen: tf.init(gen, cfg, dev),
                     specs, dev, "decode")


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
