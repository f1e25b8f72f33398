"""Synthetic vector corpora (port of ``repro.data.synthetic``'s ANN part).

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


def clustered_vectors(spec: VectorDatasetSpec, generator: torch.Generator | None = None,
                      device: str | torch.device = "cuda"):
    """Gaussian-mixture corpus + held-out queries from the same mixture,
    made on ``device`` (the generator must live there; None seeds one with
    0). Returns (x (n, d), queries (n_queries, d)), float32."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(high, size):
        return torch.randint(0, high, (size,), generator=gen, device=dev)

    centers = normal(spec.n_clusters, spec.d)
    x = centers[randint(spec.n_clusters, spec.n)] + spec.cluster_std * normal(spec.n, spec.d)
    q = centers[randint(spec.n_clusters, spec.n_queries)] \
        + spec.cluster_std * normal(spec.n_queries, spec.d)
    return x.float(), q.float()
