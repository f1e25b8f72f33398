"""Whole builds of an SQ8 index back to back (traffic ``"driver":
"build_sq8"``): the corpus stored as per-dimension int8 codes, the graph
built over them, searches over them with an f32 rerank.

The driver's own doors into the program, beside those of
``portbench/harness/program.py``: :func:`bound_build` (the bound
``ann_build`` step, its quantization checked against the configuration
file's ``quant``), :func:`encode` (``quant.encode_corpus``),
:func:`search_config` and :func:`search` (``core.search.search_tiled`` with
the codes, ``qx=``).

Set-up and window are the ``build`` driver's: the corpus and the query pool
from the seed, the build warmed with ``warmup_t1`` x ``warmup_t2`` sweeps,
then whole builds through the bound step while the window has room.
``build_s`` is the window's time over the builds completed. After the
window the corpus is encoded and the pool searched on the last graph over
the codes, with the f32 rerank of ``quant.rerank_k``, in tiles of
``search_tile`` lanes; that answer set gives ``recall_at_10``.

The checks: the graph's sampled rows against the reference's float64
decode of the program's codes, since the graph is built over the decoded
rows; ``codes_bad``, the program's codes more than one step from the
reference's (``portbench/reference/sq8.py``: the one step is a tie of the
rule that float32 rounds the other way) on every row that graph check
reads, its sampled rows and all their live neighbours; every answer
against the exact float64 10-NN over the f32 rows.

The control (``precision``): the program's lower-precision paths, the
build's ``gram_dtype`` gathers over the decoded rows (no codes) and the
answers' distances taken from the codes (no f32 rerank).
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.drivers import build as whole_builds
from portbench.harness import compare, data, program
from portbench.harness.runner import Check
from portbench.reference import sq8 as ref_sq8


def bound_build(ctx):
    """(``fn(x, generator) -> graph``, its config): the bound step, after
    checking that its config and input shape (``program.build_step``) and its
    quantization are the configuration file's."""
    fn, cfg = program.build_step(ctx.cfg, ctx.device)
    got = {k: getattr(cfg.quant, k) for k in ctx.cfg["quant"]}
    if got != ctx.cfg["quant"]:
        raise ValueError(f"the bound config's quantization {got} is not "
                         f"{ctx.cfg['name']}'s {ctx.cfg['quant']}")
    return fn, cfg


def encode(x, quant):
    """The program's codes of the corpus (``QuantizedCorpus``)."""
    from repro_torch.quant import quantization
    return quantization.encode_corpus(x, quant)


def control_build(cfg, x, precision: str):
    """(``fn``, config) of the control: a build with ``gram_dtype`` =
    ``precision`` over the program's decode of its codes, no codes."""
    from repro_torch.core import rnn_descent
    from repro_torch.quant import Quantization, quantization
    x_hat = quantization.dequantize(encode(x, cfg.quant))
    low = dataclasses.replace(cfg, quant=Quantization(), gram_dtype=precision)
    return (lambda _x, gen: rnn_descent.build(x_hat, low, gen)), low


def search_config(ctx, quant):
    """The configuration's search over the codes; the control drops the f32
    rerank."""
    from repro_torch.core.search import SearchConfig
    kw = {k: v for k, v in ctx.cfg["search"].items() if k != "entry"}
    if ctx.precision is not None:
        quant = dataclasses.replace(quant, rerank_k=0)
    return SearchConfig(**kw, quant=quant)


def search(x, graph, queries, entry, scfg, tile: int, qx):
    """``core.search.search_tiled`` over the codes ``qx``: (ids, dists)."""
    from repro_torch.core.search import search_tiled
    return search_tiled(x, graph, queries, entry, scfg, tile_b=tile, qx=qx)


def setup(ctx):
    build, cfg = bound_build(ctx)       # first: a program without the shape stops here
    x, q = data.make(ctx)
    run_cfg = cfg
    if ctx.precision is not None:
        build, run_cfg = control_build(cfg, x, ctx.precision)
    program.warm_build(run_cfg, x, data.generator(ctx.seed, 1, ctx.device),
                       ctx.mix["warmup_t1"], ctx.mix["warmup_t2"])
    return {"x": x, "q": q, "build": build, "quant": cfg.quant}


window = whole_builds.window


def judge(ctx, st):
    x, q, g, quant = st["x"], st["q"], st["graph"], st["quant"]
    del st["build"]
    qx = encode(x, quant)
    ids, dists = search(x, g, q, program.entry_point(ctx.cfg, x), search_config(ctx, quant),
                        ctx.mix["search_tile"], qx)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    scale, zero = ref_sq8.fit(x)
    n = x.shape[0]
    rows = compare.sample_rows(ctx.seed, n, ctx.mix["check_rows"], x.device)
    nbrs = g.neighbors[rows]
    used = torch.unique(torch.cat([rows, nbrs[(nbrs >= 0) & (nbrs < n)].to(rows.dtype)]))
    checks = [Check("codes_bad", ref_sq8.far_rows(qx.codes, x, used, scale, zero), 0)]
    checks += compare.graph_checks(ctx, ref_sq8.decode(qx.codes, scale, zero), g)
    more, recall = compare.answer_checks(ctx, x, q, ids, dists)
    return checks + more, {"recall_at_10": recall, "failed": 0}
