"""The benchmark's inputs, made from ``--seed`` on the run's device.

A configuration's ``data.kind`` names the file that makes them,
``portbench/data/<kind>.py`` (``make(spec, n, d, queries, seed, device) ->
(corpus, queries)``): a new kind of data, such as a dataset's real vectors
once they are in the repository, is a new file. Made here, not by the
program, and handed to both the program and the reference. The same seed
gives the same inputs.
"""
from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of random numbers of a
    seed: 0 the rows, 1.. the program's builds, 98 a mixture's centres, 99
    the rows the check samples."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)


def make(ctx, queries: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(corpus (n, d), queries) of the run's configuration, ``queries`` rows
    of queries (None: the configuration's pool)."""
    cfg = ctx.cfg
    nq = cfg["queries"] if queries is None else queries
    return ctx.data_kind.make(cfg["data"], cfg["n"], cfg["d"], nq, ctx.seed, ctx.device)
