"""Relative NN-Descent (paper Algorithm 6), port of ``repro.core.rnn_descent``.

    G <- RandomGraph(S); all flags "new"
    repeat T1 times:
        repeat T2 times:  UpdateNeighbors(G)       (Alg. 4)
        unless last:      AddReverseEdges(G, R)    (Alg. 5)

Every vertex is updated in parallel per sweep; replacement edges (w -> v)
from the fused RNG prune are buffered and merged (bucketed merge by default,
the sort oracle on request). The fused prune is the ``rng_prune`` CUDA kernel
on the card and its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor
from repro_torch.core import graph as G
from repro_torch.kernels.rng_prune import ops as rng_ops

GRAM_DTYPES = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class RNNDescentConfig:
    """Paper defaults: S=20, R=96, T1=4, T2=15 (§5.1)."""

    s: int = 20            # out-degree of the random initial graph
    r: int = 96            # reverse-edge degree cap
    t1: int = 4            # outer iterations (reverse-edge phases: t1 - 1)
    t2: int = 15           # UpdateNeighbors sweeps per outer iteration
    capacity: int = 128    # static adjacency capacity M (>= r)
    metric: str = "l2"
    chunk: int = 512       # rows per gathered block of the plain prune
    gram_dtype: str = "f32"    # "bf16": the prune gathers bf16 rows, f32 Gram
    merge: str = "bucketed"    # "bucketed" (scatter buckets) | "sort" (oracle)
    n_buckets: int | None = None   # bucket width override (power of two)

    def __post_init__(self):
        if self.capacity < self.r:
            raise ValueError(
                f"capacity={self.capacity} must hold the R={self.r} reverse "
                "edges added by AddReverseEdges (capacity >= r)")
        if self.merge not in G.MERGE_MODES:
            raise ValueError(
                f"unknown merge mode {self.merge!r}: expected one of "
                f"{G.MERGE_MODES}")
        if self.gram_dtype not in GRAM_DTYPES:
            raise ValueError(
                f"unknown gram_dtype {self.gram_dtype!r}: expected one of "
                f"{GRAM_DTYPES}")


def random_init(x: torch.Tensor, cfg: RNNDescentConfig,
                generator: torch.Generator | None = None) -> G.Graph:
    """RandomGraph(S)."""
    return G.random_init_graph(x, cfg.s, cfg.capacity, cfg.metric, generator)


def gram_input(x: torch.Tensor, cfg: RNNDescentConfig) -> torch.Tensor:
    """The corpus as the prune gathers it (bf16 under ``gram_dtype="bf16"``)."""
    return x.to(torch.bfloat16) if cfg.gram_dtype == "bf16" else x


def prune_rows(x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
               flags: torch.Tensor, cfg: RNNDescentConfig):
    """Fused prune over a block of adjacency rows -> (keep bool, red_w, red_d)."""
    keep, red_w, red_d = rng_ops.rng_prune(x, ids, dists, flags,
                                           metric=cfg.metric, chunk=cfg.chunk)
    return keep.bool(), red_w, red_d


def update_neighbors(x: torch.Tensor, g: G.Graph, cfg: RNNDescentConfig) -> G.Graph:
    """Paper Algorithm 4, one parallel sweep over all vertices: keep the RNG
    survivors (flags become "old"), and merge each dropped v's replacement
    edge (w -> v) into w's row, flagged "new". ``x`` is cast to the gram
    dtype if it is not in it already."""
    keep, red_w, red_d = prune_rows(gram_input(x, cfg), g.neighbors, g.dists,
                                    g.flags, cfg)
    inf = torch.tensor(float("inf"), device=g.dists.device)
    pruned = G.sort_rows(G.Graph(
        neighbors=torch.where(keep, g.neighbors, -1),
        dists=torch.where(keep, g.dists, inf),
        flags=torch.zeros_like(g.flags),
    ))
    cand_dst = torch.where(red_w >= 0, g.neighbors, -1)
    return G.merge_candidate_edges(pruned, red_w.reshape(-1), cand_dst.reshape(-1),
                                   red_d.reshape(-1), merge=cfg.merge,
                                   n_buckets=cfg.n_buckets)


def add_reverse_edges(g: G.Graph, cfg: RNNDescentConfig) -> G.Graph:
    """Paper Algorithm 5."""
    return G.add_reverse_edges(g, cfg.r, merge=cfg.merge, n_buckets=cfg.n_buckets)


def build(x, cfg: RNNDescentConfig, generator: torch.Generator | None = None,
          device: str | torch.device = "cuda") -> G.Graph:
    """Paper Algorithm 6. ``x`` (n, d) float32: a tensor runs on its own
    device; numpy input is placed on ``device``. ``generator`` (on x's
    device) draws the random initial graph; None seeds one with 0."""
    x = as_tensor(x, device, torch.float32)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    g = random_init(x, cfg, generator)
    xg = gram_input(x, cfg)              # cast once per build, not per sweep
    for t1 in range(cfg.t1):
        for _ in range(cfg.t2):
            g = update_neighbors(xg, g, cfg)
        if t1 != cfg.t1 - 1:
            g = add_reverse_edges(g, cfg)
    return g
