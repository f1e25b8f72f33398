"""Synthetic vectors at a dataset's published shape (data ``"kind":
"gaussian_mixture"``), in place of vectors that are not in the repository.

``clusters`` centres N(0, 1), drawn once from the configuration's
``centres_seed``, so that every seed searches the same mixture (centres drawn
from the run's seed changed the work itself: one seed's search ran 8 % slower
in every run). Each row, corpus and queries alike, is a centre picked
uniformly plus N(0, cluster_std^2) noise, drawn from the run's seed.
"""
from __future__ import annotations

import torch

from portbench.harness.data import generator

CENTRES_STREAM = 98


def make(spec: dict, n: int, d: int, queries: int, seed: int, device):
    """(corpus (n, d), queries (queries, d)) float32 on ``device``."""
    k = spec["clusters"]
    centres = torch.randn((k, d), generator=generator(spec["centres_seed"], CENTRES_STREAM, device),
                          device=device)
    gen = generator(seed, 0, device)

    def draw(m):
        pick = torch.randint(0, k, (m,), generator=gen, device=device)
        out = torch.randn((m, d), generator=gen, device=device)
        out.mul_(spec["cluster_std"]).add_(centres[pick])
        return out

    x = draw(n)
    return x, draw(queries)
