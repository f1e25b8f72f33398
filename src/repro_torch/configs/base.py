"""LM, recsys and ANN glue of ``repro.configs.base``: shapes, input specs,
smoke batches and the Criteo-like vocabulary mix (the GNN glue is the next
slice of the port).

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
    family: str               # lm | recsys | ann (the reference's gnn: not ported)
    shapes: tuple[ShapeSpec, ...]
    make_config: Callable[[str | None, bool], Any]   # (shape_name, reduced) -> cfg

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}")


def pad_to(n: int, mult: int = 4096) -> int:
    """Round a sharded-dimension size up to a grid-friendly multiple (every
    mesh factorization up to 512 devices divides 4096)."""
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


# ----------------------------------------------------------- ANN (the paper)
ANN_SHAPES = (
    ShapeSpec("build_1m", "ann_build", dict(n=1_000_000, d=128)),
    ShapeSpec("build_gist", "ann_build", dict(n=1_000_000, d=960)),
    ShapeSpec("search_1m", "ann_search", dict(n=1_000_000, d=128, queries=10_000)),
)
