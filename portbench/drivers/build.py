"""Whole index builds back to back (traffic ``"driver": "build"``).

Set-up makes the corpus and the query pool from the seed and warms the
build with ``warmup_t1`` x ``warmup_t2`` sweeps of the same config. The
window runs whole builds through the bound ``ann_build`` step; a build
starts only while the window has room for it at the last build's pace, and
every window completes at least one. ``build_s`` is the window's time
(first build's start to last build's end) over the builds completed.

After the window the pool is searched on the last graph with the
configuration's search config, in tiles of ``search_tile`` lanes; that
answer set gives ``recall_at_10``. The check holds the graph's sampled
rows and every answer to the reference.
"""
from __future__ import annotations

import time

import torch

from portbench.harness import compare, data, program, tracing


def setup(ctx):
    x, q = data.make(ctx)
    build, build_cfg = program.build_step(ctx.cfg, ctx.device, ctx.precision)
    program.warm_build(build_cfg, x, data.generator(ctx.seed, 1, ctx.device),
                       ctx.mix["warmup_t1"], ctx.mix["warmup_t2"])
    return {"x": x, "q": q, "build": build}


def window(ctx, st, seconds, tracer):
    times = []
    with tracer.region(spans=True):
        start = time.perf_counter()
        while True:
            gen = data.generator(ctx.seed, 2 + len(times), ctx.device)
            t = time.perf_counter()
            st["graph"] = st["build"](st["x"], gen)
            tracing.sync(ctx.device)
            end = time.perf_counter()
            times.append(end - t)
            if end - start + times[-1] > seconds:
                break
    return {"values": {"build_s": (end - start) / len(times)},
            "attempted": len(times), "stats": {"builds": len(times)}}


def judge(ctx, st):
    x, q, g = st["x"], st["q"], st["graph"]
    scfg = program.search_config(ctx.cfg, ctx.precision)
    ids, dists = program.search(x, g, q, program.entry_point(ctx.cfg, x), scfg,
                                ctx.mix["search_tile"])
    del st["build"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare.graph_checks(ctx, x, g)
    more, recall = compare.answer_checks(ctx, x, q, ids, dists)
    return checks + more, {"recall_at_10": recall, "failed": 0}
