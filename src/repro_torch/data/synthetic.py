"""Synthetic data (port of ``repro.data.synthetic``: ANN corpora, LM,
recsys and graph batches).

SIFT/GIST/Deep are not in the repository; these Gaussian mixtures match
their dimensionalities and clustered structure. Same mixture as the
reference, drawn with torch's random numbers (not JAX's bits).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class VectorDatasetSpec:
    """Mimics the paper's Table 1 rows at configurable scale."""

    name: str
    n: int
    d: int
    n_queries: int
    n_clusters: int = 64
    cluster_std: float = 1.0

    @staticmethod
    def sift_like(n: int = 20_000, n_queries: int = 500) -> "VectorDatasetSpec":
        return VectorDatasetSpec("sift-like", n, 128, n_queries)

    @staticmethod
    def gist_like(n: int = 5_000, n_queries: int = 200) -> "VectorDatasetSpec":
        return VectorDatasetSpec("gist-like", n, 960, n_queries)

    @staticmethod
    def deep_like(n: int = 20_000, n_queries: int = 500) -> "VectorDatasetSpec":
        return VectorDatasetSpec("deep-like", n, 96, n_queries)


def mixture_centers(spec: VectorDatasetSpec, generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """The (n_clusters, d) mixture centres: the first draw
    :func:`clustered_vectors` makes from ``generator`` (None seeds one with
    0), so a generator seeded as the corpus's gives the corpus's centres."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    return torch.randn((spec.n_clusters, spec.d), generator=gen, device=dev)


def mixture_rows(centers: torch.Tensor, n: int, generator: torch.Generator,
                 cluster_std: float = 1.0) -> torch.Tensor:
    """``n`` more rows of the mixture around ``centers`` (assignments, then
    noise, from ``generator``, which lives on the centres' device)."""
    k, d = centers.shape
    pick = torch.randint(0, k, (n,), generator=generator, device=centers.device)
    noise = torch.randn((n, d), generator=generator, device=centers.device)
    return (centers[pick] + cluster_std * noise).float()


def clustered_vectors(spec: VectorDatasetSpec, generator: torch.Generator | None = None,
                      device: str | torch.device = "cuda"):
    """Gaussian-mixture corpus + held-out queries from the same mixture,
    made on ``device`` (the generator must live there; None seeds one with
    0). Returns (x (n, d), queries (n_queries, d)), float32."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    centers = mixture_centers(spec, gen, dev)
    return (mixture_rows(centers, spec.n, gen, spec.cluster_std),
            mixture_rows(centers, spec.n_queries, gen, spec.cluster_std))


def token_batch(generator: torch.Generator, batch: int, seq: int, vocab: int,
                device: str | torch.device = "cuda") -> dict:
    """Synthetic LM batch made on ``device`` from ``generator``: a Zipf-like
    token stream ``clip(int(vocab * u^3), 0, vocab - 1)``, u uniform in
    [1e-6, 1), and next-token labels (the stream shifted by one); both
    (batch, seq) int32."""
    dev = resolve_device(device)
    u = 1e-6 + (1.0 - 1e-6) * torch.rand(batch, seq + 1, generator=generator, device=dev)
    toks = torch.clamp((vocab * u ** 3.0).to(torch.int32), 0, vocab - 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def recsys_batch(generator: torch.Generator, batch: int, n_fields: int,
                 vocab_sizes: tuple[int, ...], n_dense: int = 13, multi_hot: int = 1,
                 device: str | torch.device = "cuda") -> dict:
    """Criteo-style batch made on ``device`` from ``generator`` (which must
    live there): dense feats (batch, n_dense) f32, per-field categorical ids
    (batch, n_fields, multi_hot) int32 below each field's vocabulary (field
    f uses ``vocab_sizes[f % len]``), labels (batch,) f32 with P(1) = 0.3."""
    dev = resolve_device(device)
    dense = torch.randn(batch, n_dense, generator=generator, device=dev)
    sparse = torch.stack([
        torch.randint(0, vocab_sizes[f % len(vocab_sizes)], (batch, multi_hot),
                      generator=generator, device=dev, dtype=torch.int32)
        for f in range(n_fields)], dim=1)                      # (batch, n_fields, multi_hot)
    labels = (torch.rand(batch, generator=generator, device=dev) < 0.3).float()
    return {"dense": dense, "sparse_ids": sparse, "labels": labels}


def random_graph_batch(generator: torch.Generator, n_nodes: int, n_edges: int, d_feat: int,
                       positions: bool = False, device: str | torch.device = "cuda") -> dict:
    """Synthetic graph made on ``device`` from ``generator``: a uniform
    int32 edge index (src, then dst), N(0, 1) node features (n_nodes,
    d_feat) and, with ``positions``, N(0, 1) 3-D positions (molecular
    nets)."""
    dev = resolve_device(device)
    src = torch.randint(0, n_nodes, (n_edges,), generator=generator, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, n_nodes, (n_edges,), generator=generator, device=dev,
                        dtype=torch.int32)
    out = {"edge_src": src, "edge_dst": dst,
           "node_feat": torch.randn((n_nodes, d_feat), generator=generator, device=dev)}
    if positions:
        out["pos"] = torch.randn((n_nodes, 3), generator=generator, device=dev)
    return out
