"""The benchmark's only doors into the program (``repro_torch``): the bound
build step, the search entry and the entry point. Everything the program
is asked is named here, so a reader sees what the benchmark times.

``precision`` selects the program's own lower-precision path (the
``gram_dtype="bf16"`` gathers of the build's prune and of the search's beam
kernel), which the benchmark runs only as the control of its comparison.
"""
from __future__ import annotations

import dataclasses

import torch


def build_step(cfg: dict, device, precision: str | None = None):
    """(``fn(x, generator) -> graph``, its build config): the cell
    ``launch.steps.bind(arch, shape)`` binds, after checking that its config
    and input shape are the configuration file's. With ``precision`` the
    same config with that gram dtype, through ``rnn_descent.build``."""
    from repro_torch.launch import steps
    b = cfg["bind"]
    bound = steps.bind(b["arch"], b["shape"], reduced=b["reduced"], device=device)
    differ = {k: (v, getattr(bound.cfg, k)) for k, v in cfg["build"].items()
              if getattr(bound.cfg, k) != v}
    shape = tuple(bound.input_specs["x"][0])
    if differ or shape != (cfg["n"], cfg["d"]):
        raise ValueError(f"bind{tuple(b.values())} is not {cfg['name']}: config {differ}, "
                         f"shape {shape} against ({cfg['n']}, {cfg['d']})")
    if precision is None:
        return (lambda x, gen: bound.step_fn({}, {"x": x, "generator": gen})), bound.cfg
    from repro_torch.core import rnn_descent
    low = dataclasses.replace(bound.cfg, gram_dtype=precision)
    return (lambda x, gen: rnn_descent.build(x, low, gen)), low


def warm_build(build_cfg, x, gen, t1: int, t2: int):
    """``build_cfg`` cut to ``t1`` x ``t2`` sweeps: with t1 >= 2 every
    kernel and shape of a whole build runs, and the allocator's pool grows
    to a whole build's size."""
    from repro_torch.core import rnn_descent
    return rnn_descent.build(x, dataclasses.replace(build_cfg, t1=t1, t2=t2), gen)


def search_config(cfg: dict, precision: str | None = None):
    from repro_torch.core.search import SearchConfig
    kw = {k: v for k, v in cfg["search"].items() if k != "entry"}
    if precision is not None:
        kw["gram_dtype"] = precision
    return SearchConfig(**kw)


def entry_point(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["search"]["entry"] != "centroid_nearest":
        raise ValueError(f"unknown entry {cfg['search']['entry']!r}")
    from repro_torch.core.search import default_entry_point
    return default_entry_point(x, cfg["search"]["metric"])


def search(x, graph, queries, entry, scfg, tile: int, with_stats: bool = False):
    """``core.search.search_tiled``: (ids, dists) or (ids, dists, stats)."""
    from repro_torch.core.search import search_tiled
    return search_tiled(x, graph, queries, entry, scfg, tile_b=tile, with_stats=with_stats)
