"""Bind (arch, shape) -> the step the cell runs (recsys and ann branches of
``repro.launch.steps``).

``bind`` returns, for a recsys cell of kind ``serve`` or ``retrieval`` and
for the paper's ``ann_build`` and ``ann_search`` cells, the config, an init
function, the input shapes and the step function, all on one device.
Training cells belong to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import configs, resolve_device
from repro_torch.configs import base as cb
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import recsys as rs


@dataclasses.dataclass
class BoundStep:
    arch_id: str
    shape: ShapeSpec
    cfg: Any
    step_fn: Callable            # (params, batch) -> scores | (top, idx) | graph | (ids, dists)
    init_fn: Callable            # (torch.Generator) -> params on the step's device
    input_specs: dict            # {name: (shape, dtype)}
    device: torch.device
    kind: str


def bind(arch_id: str, shape_name: str, reduced: bool = False,
         device: str | torch.device = "cuda") -> BoundStep:
    arch = configs.get(arch_id)
    shape = arch.shape(shape_name)
    cfg = arch.make_config(shape_name, reduced)
    dev = resolve_device(device)
    if arch.family == "ann":
        return _bind_ann(arch, shape, cfg, reduced, dev)
    specs = cb.recsys_input_specs(cfg, shape, reduced)

    if shape.kind == "retrieval":
        def retrieve_fn(params, batch):
            return rs.score_candidates(batch["query_emb"], batch["cand_embs"], k=100)

        return BoundStep(arch_id, shape, cfg, retrieve_fn, lambda gen: {}, specs, dev,
                         "retrieval")
    if shape.kind == "train":
        raise NotImplementedError(
            f"{arch_id}/{shape_name}: recsys training (loss, optimizer, the fm_interact "
            "backward) is a later slice of the port")

    def serve_fn(params, batch):
        return rs.serve(params, batch, cfg)

    return BoundStep(arch_id, shape, cfg, serve_fn, lambda gen: rs.init(gen, cfg, dev),
                     specs, dev, "serve")


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
