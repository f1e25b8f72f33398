"""One closed-loop client sending batches of queries (traffic
``"driver": "batch_search"``).

Set-up makes the corpus and a pool of ``pool`` held-out queries from the
seed, builds the graph through the bound ``ann_build`` step, finds the entry
point and sends ``warm_calls`` batches. The pool holds whole batches, so no
batch asks a query twice. In the window the client sends batch after batch
of ``batch`` queries, taken from the pool in turn (batch i holds pool rows
i * batch ... modulo the pool), each through ``core.search.search_tiled``
with one tile of the whole batch, and waits for each answer; a batch is sent
only while the window lasts. ``search_qps`` is the queries answered over the
window's time (its start to the last answer); ``search_p90_ms`` the 90th
percentile of every call's time on the host's clock, from the call to the
return of the synchronisation that waits for its answer (a call of 16,384
queries lasts 300 ms or more).

The traced run asks the search for its lane counters in every call and
profiles calls ``profile_skip`` .. ``profile_skip + profile_calls - 1``.
The check holds every answer to the reference.
"""
from __future__ import annotations

import time

import torch

from portbench.harness import compare, data, program, stats, tracing

# the tail: a 51 s window holds 110-160 calls of 16,384 queries, and the
# 90th percentile has ten or more calls beyond it (the 95th only 5-8)
TAIL = 90


def setup(ctx):
    b, pool = ctx.mix["batch"], ctx.mix["pool"]
    if pool % b:
        raise ValueError(f"a pool of {pool} queries is no whole number of batches of {b}")
    x, q = data.make(ctx, pool)
    build, _ = program.build_step(ctx.cfg, ctx.device)
    graph = build(x, data.generator(ctx.seed, 1, ctx.device))
    entry = program.entry_point(ctx.cfg, x)
    scfg = program.search_config(ctx.cfg, ctx.precision)
    lanes = torch.arange(b, device=ctx.device)
    for i in range(ctx.mix["warm_calls"]):
        program.search(x, graph, q[(i * b + lanes) % q.shape[0]], entry, scfg, b)
    st = {"x": x, "q": q, "graph": graph, "entry": entry, "scfg": scfg, "lanes": lanes}
    if ctx.trace:
        valid = (graph.neighbors[:, :scfg.k] >= 0).sum(dim=1)
        st["valid_per_expansion"] = float(valid.double().mean())
    return st


def window(ctx, st, seconds, tracer):
    x, q, g, entry, scfg, lanes = (st[k] for k in ("x", "q", "graph", "entry", "scfg", "lanes"))
    b, pool = ctx.mix["batch"], q.shape[0]
    ms, ids, dists, asked = [], [], [], []
    counts = {"work": 0, "launched": 0, "profiled_work": 0}

    def call(profiled: bool) -> None:
        rows = (len(ms) * b + lanes) % pool
        t = time.perf_counter()
        out = program.search(x, g, q[rows], entry, scfg, b, with_stats=ctx.trace)
        tracing.sync(ctx.device)
        ms.append(1e3 * (time.perf_counter() - t))
        ids.append(out[0])
        dists.append(out[1])
        asked.append(rows)
        if ctx.trace:
            counts["work"] += out[2]["work"]
            counts["launched"] += out[2]["launched"]
            if profiled:
                counts["profiled_work"] += out[2]["work"]

    start = time.perf_counter()
    skip, prof = (ctx.mix["profile_skip"], ctx.mix["profile_calls"]) if ctx.trace else (0, 0)
    while len(ms) < skip and time.perf_counter() - start < seconds:
        call(False)
    if prof:
        with tracer.region(spans=False):
            for _ in range(prof):
                if time.perf_counter() - start >= seconds:
                    break
                call(True)
    while time.perf_counter() - start < seconds:
        call(False)
    tracing.sync(ctx.device)
    end = time.perf_counter()
    st["answers"] = (torch.cat(ids), torch.cat(dists), torch.cat(asked))
    return {"values": {"search_qps": stats.rate(len(ms) * b, end - start),
                       "search_p90_ms": stats.percentile(ms, TAIL)},
            "attempted": len(ms) * b,
            "stats": {**counts, "tile": b, "k": scfg.k, "d": x.shape[1],
                      "itemsize": 2 if scfg.effective_gram_dtype == "bf16" else 4,
                      "valid_per_expansion": st.get("valid_per_expansion")}}


def judge(ctx, st):
    ids, dists, asked = st.pop("answers")
    x, q = st["x"], st["q"]
    del st["graph"]
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, recall = compare.answer_checks(ctx, x, q, ids, dists, asked)
    return checks, {"recall_at_10": recall, "failed": int(checks[0].value)}
