"""The glue of ``repro.configs.base``: the LM, GNN, recsys and ANN shapes,
input specs, smoke batches and the Criteo-like vocabulary mix.

Step kinds per cell:
  train     -> gradients + AdamW update (``train.step``)
  prefill   -> LM full-sequence prefill, fills the KV cache
  decode    -> LM one new token against a seq-long KV cache
  serve     -> recsys forward (sigmoid scores)
  retrieval -> recsys candidate scoring (1 query x n_candidates)
  ann_build -> RNN-Descent index construction (the paper)
  ann_search-> beam search over a built graph
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                 # train | prefill | decode | serve | retrieval | ann_build | ann_search
    dims: dict


@dataclasses.dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str               # lm | gnn | recsys | ann
    shapes: tuple[ShapeSpec, ...]
    make_config: Callable[[str | None, bool], Any]   # (shape_name, reduced) -> cfg

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}")


def pad_to(n: int, mult: int = 4096) -> int:
    """Round a sharded-dimension size up to a grid-friendly multiple (every
    mesh factorization up to 512 devices divides 4096). Pipelines mask-pad;
    models consume the masks (edge_mask / triplet_mask / score masking)."""
    return -(-n // mult) * mult


# ------------------------------------------------------------------ LM glue
LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq=4096, batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq=32768, batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq=32768, batch=128)),
    # decode against a 512k cache is O(seq), not O(seq^2)
    ShapeSpec("long_500k", "decode", dict(seq=524288, batch=1)),
)

LM_SMOKE = dict(seq=32, batch=2, cache=48)


def lm_input_specs(cfg, shape: ShapeSpec, reduced: bool = False) -> dict:
    """``{name: (shape, dtype)}`` of every input of the cell's step (the
    decode cache as a nested dict)."""
    if reduced:
        b, s, cache_len = LM_SMOKE["batch"], LM_SMOKE["seq"], LM_SMOKE["cache"]
    else:
        b, s = shape.dims["batch"], shape.dims["seq"]
        cache_len = shape.dims["seq"]
    tok = ((b, s), torch.int32)
    if shape.kind == "train":
        return {"tokens": tok, "labels": tok}
    if shape.kind == "prefill":
        return {"tokens": tok}
    if shape.kind == "decode":
        cache_shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.d_head)
        return {"tokens": ((b,), torch.int32),
                "cache": {"k": (cache_shape, cfg.compute_dtype),
                          "v": (cache_shape, cfg.compute_dtype),
                          "pos": ((b,), torch.int32)}}
    raise ValueError(shape.kind)


def lm_smoke_batch(generator: torch.Generator, cfg, shape: ShapeSpec,
                   device: str | torch.device = "cuda") -> dict:
    """A reduced batch of the cell's inputs from ``generator`` (on
    ``device``): train tokens and next-token labels of one (B, S + 1) draw;
    prefill tokens; decode a cache half full (``pos`` = cache / 2) of
    N(0, 1) * 0.02 keys, then values, then the tokens."""
    from repro_torch.models import transformer as tf
    dev = resolve_device(device)
    b, s = LM_SMOKE["batch"], LM_SMOKE["seq"]
    if shape.kind == "train":
        t = torch.randint(0, cfg.vocab, (b, s + 1), generator=generator, device=dev,
                          dtype=torch.int32)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if shape.kind == "prefill":
        return {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=generator, device=dev,
                                        dtype=torch.int32)}
    cache = tf.init_cache(cfg, b, LM_SMOKE["cache"], device=dev)
    cache["pos"] = torch.full((b,), LM_SMOKE["cache"] // 2, dtype=torch.int32, device=dev)
    for name in ("k", "v"):
        cache[name] = (torch.randn(cache[name].shape, generator=generator, device=dev)
                       * 0.02).to(cfg.compute_dtype)
    return {"tokens": torch.randint(0, cfg.vocab, (b,), generator=generator, device=dev,
                                    dtype=torch.int32),
            "cache": cache}


def make_lm_arch(arch_id: str, full, smoke) -> Arch:
    def make_config(shape_name, reduced):
        return smoke if reduced else full
    return Arch(arch_id, "lm", LM_SHAPES, make_config)


# ----------------------------------------------------------------- GNN glue
GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              dict(n_nodes=2708, n_edges=pad_to(10556), d_feat=1433, n_out=7,
                   triplets=pad_to(8 * 10556), impl="gather")),
    ShapeSpec("minibatch_lg", "train",
              dict(n_nodes=1024 * 166, n_edges=pad_to(1024 * 165), d_feat=602,
                   n_out=41, seeds=1024, fanout=(15, 10), impl="factorized",
                   edge_chunks=1)),
    ShapeSpec("ogb_products", "train",
              dict(n_nodes=2449029, n_edges=pad_to(61859140), d_feat=100,
                   n_out=47, impl="factorized", edge_chunks=8)),
    ShapeSpec("molecule", "train",
              dict(n_nodes=128 * 30, n_edges=128 * 64, d_feat=16, n_out=1,
                   n_graphs=128, triplets=8 * 128 * 64, impl="gather",
                   task="graph_reg")),
)

GNN_SMOKE_NODE_SCALE = 64    # nodes divided by this in smoke tests
GNN_SMOKE_EDGE_SCALE = 256   # edges/triplets divided by this in smoke tests


def gnn_input_specs(cfg, shape: ShapeSpec, reduced: bool = False) -> dict:
    """``{name: (shape, dtype)}`` of every input of the cell's step: the
    factorized cells' edge arrays arrive chunked (edge_chunks, ce)."""
    d = dict(shape.dims)
    n, e = d["n_nodes"], d["n_edges"]
    if reduced:
        n = max(n // GNN_SMOKE_NODE_SCALE, 32)
        e = max(e // GNN_SMOKE_EDGE_SCALE, 64)
    f32, i32 = torch.float32, torch.int32
    cch = d.get("edge_chunks", 1)
    ce = e // cch
    e = cch * ce
    eshape = (cch, ce) if d["impl"] == "factorized" else (e,)
    specs = {"node_feat": ((n, d["d_feat"]), f32), "pos": ((n, 3), f32),
             "edge_src": (eshape, i32), "edge_dst": (eshape, i32), "edge_mask": (eshape, f32)}
    if d.get("task") == "graph_reg":
        ng = d["n_graphs"] if not reduced else max(d["n_graphs"] // 16, 2)
        specs["graph_ids"] = ((n,), i32)
        specs["labels"] = ((ng,), f32)
        specs["node_mask"] = ((n,), f32)
    else:
        specs["labels"] = ((n,), i32)
        specs["label_mask"] = ((n,), f32)
    if d["impl"] == "gather":
        t = d["triplets"] if not reduced else max(d["triplets"] // GNN_SMOKE_EDGE_SCALE, 64)
        specs["triplet_kj"] = ((t,), i32)
        specs["triplet_ji"] = ((t,), i32)
        specs["triplet_mask"] = ((t,), f32)
    return specs


def gnn_smoke_batch(generator: torch.Generator, cfg, shape: ShapeSpec,
                    device: str | torch.device = "cuda") -> dict:
    """A reduced batch of the cell's inputs from ``generator`` (on
    ``device``): N(0, 1) features, N(0, 4) positions, uniform edges with
    no self loop (dst == src moves to (dst + 1) mod n), every mask one;
    per-graph N(0, 1) labels over contiguous node ranges (graph_reg) or
    uniform classes; uniform triplet edge ids (gather)."""
    dev = resolve_device(device)
    specs = gnn_input_specs(cfg, shape, reduced=True)
    d = dict(shape.dims)
    n = specs["node_feat"][0][0]
    eshape = specs["edge_src"][0]

    def ints(hi, s):
        return torch.randint(0, hi, s, generator=generator, device=dev, dtype=torch.int32)

    batch = {"node_feat": torch.randn((n, d["d_feat"]), generator=generator, device=dev),
             "pos": torch.randn((n, 3), generator=generator, device=dev) * 2.0,
             "edge_src": ints(n, eshape), "edge_dst": ints(n, eshape),
             "edge_mask": torch.ones(eshape, device=dev)}
    batch["edge_dst"] = torch.where(batch["edge_dst"] == batch["edge_src"],
                                    (batch["edge_dst"] + 1) % n, batch["edge_dst"])
    if d.get("task") == "graph_reg":
        ng = specs["labels"][0][0]
        batch["graph_ids"] = torch.clamp(torch.arange(n, device=dev) * ng // n, 0, ng - 1) \
            .to(torch.int32)
        batch["labels"] = torch.randn((ng,), generator=generator, device=dev)
        batch["node_mask"] = torch.ones((n,), device=dev)
    else:
        batch["labels"] = ints(d["n_out"], (n,))
        batch["label_mask"] = torch.ones((n,), device=dev)
    if d["impl"] == "gather":
        t = specs["triplet_kj"][0][0]
        n_e = math.prod(eshape)
        batch["triplet_kj"] = ints(n_e, (t,))
        batch["triplet_ji"] = ints(n_e, (t,))
        batch["triplet_mask"] = torch.ones((t,), device=dev)
    return batch


def make_gnn_arch(arch_id: str, base, smoke) -> Arch:
    def make_config(shape_name, reduced):
        tmpl = smoke if reduced else base
        if shape_name is None:
            return tmpl
        d = dict(next(s for s in GNN_SHAPES if s.name == shape_name).dims)
        return dataclasses.replace(
            tmpl, d_feat=d["d_feat"], n_out=d["n_out"],
            task=d.get("task", "node_class"), triplet_impl=d["impl"],
            edge_chunks=d.get("edge_chunks", 1))
    return Arch(arch_id, "gnn", GNN_SHAPES, make_config)


# -------------------------------------------------------------- recsys glue
RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)

RECSYS_SMOKE = dict(batch=32, n_candidates=2048)


def recsys_input_specs(cfg, shape: ShapeSpec, reduced: bool = False) -> dict:
    """``{name: (shape, dtype)}`` of every input of the cell's step."""
    b = RECSYS_SMOKE["batch"] if reduced else shape.dims["batch"]
    if shape.kind == "retrieval":
        nc = RECSYS_SMOKE["n_candidates"] if reduced else pad_to(shape.dims["n_candidates"])
        return {"query_emb": ((cfg.embed_dim,), torch.float32),
                "cand_embs": ((nc, cfg.embed_dim), torch.float32)}
    specs = {"sparse_ids": ((b, cfg.n_fields, cfg.multi_hot), torch.int32),
             "dense": ((b, cfg.n_dense), torch.float32)}
    if shape.kind == "train":
        specs["labels"] = ((b,), torch.float32)
    return specs


def recsys_smoke_batch(generator: torch.Generator, cfg, shape: ShapeSpec,
                       device: str | torch.device = "cuda") -> dict:
    """A reduced batch of the cell's inputs, drawn from ``generator`` (which
    must live on ``device``); ids below the smallest field's vocabulary."""
    dev = resolve_device(device)
    specs = recsys_input_specs(cfg, shape, reduced=True)
    if shape.kind == "retrieval":
        return {name: torch.randn(s, generator=generator, device=dev)
                for name, (s, _) in specs.items()}
    batch = {
        "sparse_ids": torch.randint(0, min(cfg.vocab_sizes), specs["sparse_ids"][0],
                                    generator=generator, device=dev, dtype=torch.int32),
        "dense": torch.randn(specs["dense"][0], generator=generator, device=dev),
    }
    if shape.kind == "train":
        b = specs["labels"][0]
        batch["labels"] = (torch.rand(b, generator=generator, device=dev) < 0.3).float()
    return batch


def criteo_vocab_sizes(n_fields: int, reduced: bool = False) -> tuple[int, ...]:
    """Deterministic Criteo-like vocab mix: few huge fields, long small tail.
    The last field is padded so the stacked table's row count is shardable
    over every mesh factorization (row-sharded embedding tables)."""
    big = [10_000_000, 4_000_000, 1_000_000, 1_000_000]
    mid = [100_000] * 8 + [10_000] * 10
    small = [1_000] * 9 + [100] * 8
    sizes = (big + mid + small) * 2
    sizes = list(sizes[:n_fields])
    if reduced:
        sizes = [min(s, 1000) for s in sizes]
    total = sum(sizes)
    sizes[-1] += pad_to(total) - total
    return tuple(sizes)


def make_recsys_arch(arch_id: str, full, smoke) -> Arch:
    def make_config(shape_name, reduced):
        return smoke if reduced else full
    return Arch(arch_id, "recsys", RECSYS_SHAPES, make_config)


def smoke_batch(family: str):
    """The family's reduced-batch builder: ``(generator, cfg, shape,
    device) -> batch`` (lm, gnn, recsys)."""
    return {"lm": lm_smoke_batch, "gnn": gnn_smoke_batch, "recsys": recsys_smoke_batch}[family]


# ----------------------------------------------------------- ANN (the paper)
ANN_SHAPES = (
    ShapeSpec("build_1m", "ann_build", dict(n=1_000_000, d=128)),
    ShapeSpec("build_gist", "ann_build", dict(n=1_000_000, d=960)),
    ShapeSpec("search_1m", "ann_search", dict(n=1_000_000, d=128, queries=10_000)),
    # the port's own (the reference has the three above): GIST1M stored as
    # per-dimension int8 codes (Faiss's SQ8), built over them
    ShapeSpec("build_gist_sq8", "ann_build", dict(n=1_000_000, d=960)),
)
