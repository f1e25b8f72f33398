"""Fixed-fanout neighbour sampler (GraphSAGE-style) for minibatch GNN
training (port of ``repro.data.sampler``).

Given a CSR graph (row_ptr/col_idx), draw ``fanout`` uniform neighbours per
frontier node per hop, vectorised, with static output shapes: seeds x
(1 + f1 + f1 f2) node slots. Duplicates across the frontier are allowed
(GraphSAGE's semantics): the model consumes the subgraph through edge
lists, so a repeated node is a repeated message.

The sampler is split into a draw and a map. The draw is
``torch.rand`` from an explicit generator on the graph's device
(:func:`two_hop_uniforms`); the map (:func:`neighbors_from_uniform`,
:func:`sample_two_hop`) is deterministic in those uniforms: given the
uniforms the reference draws (``jax.random.uniform`` of its two split
keys), the subgraph is the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device


class CSRGraph(NamedTuple):
    row_ptr: torch.Tensor   # (N+1,) int32
    col_idx: torch.Tensor   # (nnz,) int32


class SampledSubgraph(NamedTuple):
    """Static-shape 2-hop subgraph in *local* node numbering.

    nodes: (n_sub,) global ids (padded with -1); edge_src/edge_dst index into
    ``nodes``; seeds occupy nodes[:n_seeds]."""
    nodes: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor


def neighbors_from_uniform(u: torch.Tensor, g: CSRGraph, frontier: torch.Tensor) -> torch.Tensor:
    """(F,) frontier and (F, fanout) f32 uniforms in [0, 1) -> (F, fanout)
    sampled neighbour global ids: slot floor(u * max(deg, 1)) of the row,
    clamped to the last entry of col_idx; -1 for a row of degree 0 or a
    frontier entry below 0."""
    fr = frontier.long()
    deg = g.row_ptr[fr + 1] - g.row_ptr[fr]
    offs = (u * torch.clamp(deg, min=1)[:, None]).to(torch.int32)
    idx = g.row_ptr[fr][:, None] + offs
    nbrs = g.col_idx[torch.clamp(idx, max=g.col_idx.shape[0] - 1).long()]
    ok = (deg[:, None] > 0) & (frontier[:, None] >= 0)
    return torch.where(ok, nbrs, -1)


def uniform_neighbors(generator: torch.Generator, g: CSRGraph, frontier: torch.Tensor,
                      fanout: int) -> torch.Tensor:
    """(F,) frontier -> (F, fanout) sampled neighbour global ids (-1 pad),
    the uniforms drawn from ``generator`` on the graph's device."""
    u = torch.rand((frontier.shape[0], fanout), generator=generator,
                   device=g.row_ptr.device)
    return neighbors_from_uniform(u, g, frontier)


def two_hop_uniforms(generator: torch.Generator, n_seeds: int, fanout1: int, fanout2: int,
                     device: str | torch.device = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The draws of :func:`sample_two_hop`: (S, f1) for the first hop, then
    (S f1, f2) for the second, f32 uniforms from ``generator`` on
    ``device``."""
    dev = resolve_device(device)
    u1 = torch.rand((n_seeds, fanout1), generator=generator, device=dev)
    u2 = torch.rand((n_seeds * fanout1, fanout2), generator=generator, device=dev)
    return u1, u2


def sample_two_hop(uniforms: tuple[torch.Tensor, torch.Tensor], g: CSRGraph,
                   seeds: torch.Tensor, fanout1: int, fanout2: int) -> SampledSubgraph:
    """Seeds (S,) and the two hops' uniforms (:func:`two_hop_uniforms`) ->
    subgraph with S (1 + f1 + f1 f2) node slots and S f1 + S f1 f2 edge slots
    (edges point child -> parent, GraphSAGE's aggregation direction)."""
    u1, u2 = uniforms
    s = seeds.shape[0]
    dev = seeds.device
    if u1.shape != (s, fanout1) or u2.shape != (s * fanout1, fanout2):
        raise ValueError(f"uniforms {tuple(u1.shape)}, {tuple(u2.shape)} for {s} seeds at "
                         f"fanout ({fanout1}, {fanout2})")
    h1 = neighbors_from_uniform(u1, g, seeds)                          # (S, f1)
    h1_flat = h1.reshape(-1)
    h2 = neighbors_from_uniform(u2, g, torch.clamp(h1_flat, min=0))   # (S f1, f2)
    h2 = torch.where(h1_flat[:, None] >= 0, h2, -1)
    nodes = torch.cat([seeds.to(h1.dtype), h1_flat, h2.reshape(-1)])

    # local indices: seeds 0..S-1; hop 1 S..S+S f1-1; hop 2 after
    hop1_local = s + torch.arange(s * fanout1, device=dev)
    hop2_local = s + s * fanout1 + torch.arange(s * fanout1 * fanout2, device=dev)
    e1_dst = torch.arange(s, device=dev).repeat_interleave(fanout1)
    e2_dst = hop1_local.repeat_interleave(fanout2)
    edge_src = torch.cat([hop1_local, hop2_local]).to(torch.int32)
    edge_dst = torch.cat([e1_dst, e2_dst]).to(torch.int32)
    edge_mask = torch.cat([h1_flat >= 0, h2.reshape(-1) >= 0]).to(torch.float32)
    return SampledSubgraph(nodes, edge_src, edge_dst, edge_mask)


def random_csr(generator: torch.Generator, n_nodes: int, avg_degree: int,
               device: str | torch.device = "cuda") -> CSRGraph:
    """Synthetic CSR graph with uniform degree ``avg_degree`` and uniform
    int32 neighbour ids from ``generator`` on ``device``."""
    dev = resolve_device(device)
    deg = torch.full((n_nodes,), avg_degree, dtype=torch.int32, device=dev)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(deg, 0).to(torch.int32)])
    col = torch.randint(0, n_nodes, (n_nodes * avg_degree,), generator=generator, device=dev,
                        dtype=torch.int32)
    return CSRGraph(row_ptr, col)
