"""Bind (arch, shape) -> the step the cell runs (recsys branch of
``repro.launch.steps``).

``bind`` returns, for a recsys cell of kind ``serve`` or ``retrieval``, the
model config, an init function, the input shapes and the step function, all
on one device. Training cells belong to a later slice of the port.
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
    step_fn: Callable            # (params, batch) -> scores | (top, idx)
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
