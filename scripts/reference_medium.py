"""The JAX package's numbers for the medium configuration of chip_smoke.py.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_medium.py [f32 int8 pq nnd nsg churn serve gist]

Runs the reference (``repro``, jnp paths, CPU) on the SIFT-like mixture at
n = 20k with 500 queries: build ``rnnd_ann.FULL`` under each corpus mode
(f32, int8, pq; the mixture drawn by ``jax.random``), or one of the paper's
baselines (nnd: ``NNDescentConfig()``, K = 64, S = 10, 10 iterations; nsg:
``NSGStyleConfig()``, R = 32, C = 132 on that NN-Descent) over the mixture
that ``chip_smoke.numpy_mixture`` draws with numpy, the corpus and queries
chip_smoke.py's medium baselines use on the card. Then hashed
``search_tiled`` at L = K = 64, top-10 (int8 and PQ with m = 32 and the
exact-f32 rerank tail of width 64). Prints one JSON line per mode with
recall@10, recall@1, the average out-degree, the connectivity lower bound
and the seconds taken. ``chip_smoke.py`` keeps these numbers as
``REF_MEDIUM``.

``churn`` runs the streaming index over the numpy-drawn pool (n = 20k):
``chip_smoke.churn_schedule`` (``benchmarks/bench_streaming.py``'s churn
schedule) under ``StreamingConfig(build=FULL, **chip_smoke.STREAM_KW)``,
then prints ``recall_stream`` (the index's search, ``CHURN_SEARCH``,
against the ground truth over the survivors) and ``recall_rebuild`` (a
from-scratch build over the survivors, searched the same way), the bar of
chip_smoke.py's ``medium_streaming`` phase.

``serve`` replays chip_smoke.py's ``medium_serving`` f32 session on the JAX
package's serving front end (``repro.serving``) over the same pool, build
and churn script (``chip_smoke.serving_script``), under a manual clock that
moves 5 ms a request; it prints ``recall_before`` and ``recall_after``
(recall@10 over the live rows before the warm-up writes and after the
session), the bar of that phase's check on f32 (about 3.5 min on the CPU).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from repro.configs.rnnd_ann import FULL, SEARCH
from repro.core import eval as E
from repro.core import nn_descent as nnd
from repro.core import nsg_style as nsg
from repro.core import rnn_descent as rd
from repro.core import search as S
from repro.data.synthetic import VectorDatasetSpec, clustered_vectors
from repro.quant import Quantization, encode_corpus

QUANTS = {"f32": Quantization(), "int8": Quantization(mode="int8", rerank_k=64),
          "pq": Quantization(mode="pq", m=32, rerank_k=64)}
BUILDERS = {"nnd": lambda x, key: nnd.build(x, nnd.NNDescentConfig(), key),
            "nsg": lambda x, key: nsg.build(x, nsg.NSGStyleConfig(), key)}


def corpus(baseline: bool, gist: bool = False):
    """(x, queries, ground truth, entry point) of the medium configuration
    (``gist``: the 960-wide numpy-drawn corpus of chip_smoke.py's ann_gist)."""
    if baseline or gist:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from chip_smoke import GIST_MEDIUM, MEDIUM_N, MEDIUM_Q, SEED, numpy_mixture
        shape = (GIST_MEDIUM[0], GIST_MEDIUM[1], SEED, 960) if gist else \
            (MEDIUM_N, MEDIUM_Q, SEED)
        x, q = (jnp.asarray(a) for a in numpy_mixture(*shape))
    else:
        x, q = clustered_vectors(jax.random.PRNGKey(0), VectorDatasetSpec.sift_like(20_000, 500))
    _, gt = E.ground_truth(x, q, k=10)
    return x, q, gt, S.default_entry_point(x)


def churn() -> None:
    """The churn schedule of chip_smoke.py's medium_streaming phase, f32."""
    import numpy as np

    from repro.streaming import StreamingANN, StreamingConfig
    from repro.streaming import store as ST
    t0 = time.perf_counter()
    x, q, _, _ = corpus(baseline=True)
    from chip_smoke import CHURN_SEARCH, STREAM_KW, churn_schedule
    n0, schedule = churn_schedule(x.shape[0])
    cfg = StreamingConfig(build=FULL, **STREAM_KW)
    scfg = S.SearchConfig(**CHURN_SEARCH)
    ann = StreamingANN.from_corpus(x[:n0], cfg, key=jax.random.PRNGKey(1))
    for op, arg in schedule:
        if op == "ins":
            ann.insert(x[arg])
        else:
            ann.delete(arg)
    st = ann.store
    valid = ST.active_mask(st)
    _, gt = E.ground_truth(st.x, q, k=10, valid=valid)
    ids, _ = ann.search(q, scfg)
    surv = jnp.asarray(np.asarray(st.x)[np.asarray(valid)])
    g = rd.build(surv, cfg.build, jax.random.PRNGKey(2))
    ids_r, _ = S.search_tiled(surv, g, q, S.default_entry_point(surv), scfg, tile_b=256)
    _, gt_r = E.ground_truth(surv, q, k=10)
    print(json.dumps({"mode": "churn", "pool": int(x.shape[0]), "n0": n0,
                      "survivors": int(surv.shape[0]), "queries": int(q.shape[0]),
                      "recall_stream": float(E.recall_topk(ids, gt, valid=valid)),
                      "recall_rebuild": float(E.recall_topk(ids_r, gt_r)),
                      "seconds": time.perf_counter() - t0}), flush=True)


def serve() -> None:
    """chip_smoke.py's medium_serving f32 session on the JAX package: the
    numpy-drawn pool, built on its first n0 rows, grown, the serving
    warm-up writes, then SERVE_REQ requests under a ManualClock that
    advances 1 / 200 s a request (pumped after each), with the churn script
    of ``chip_smoke.serving_script``; recall@10 over the live rows before
    the warm-up and after the session."""
    import numpy as np

    from repro.serving import (AdmissionConfig, ServingConfig, ServingFrontend,
                               WriterConfig)
    from repro.streaming import StreamingANN, StreamingConfig
    from repro.streaming import store as ST
    t0 = time.perf_counter()
    x, q, _, _ = corpus(baseline=True)
    from chip_smoke import (CHURN_SEARCH, SERVE_DEADLINE, SERVE_EVENTS, SERVE_REQ,
                            SERVE_TILE, SERVE_WB, STREAM_KW, ManualClock, serving_script)
    n0 = int(x.shape[0] / 1.3)
    x_np, q_np = np.asarray(x), np.asarray(q)
    pool = x_np[n0:]
    cfg = StreamingConfig(build=FULL, **STREAM_KW)
    scfg = S.SearchConfig(**CHURN_SEARCH)
    ann = StreamingANN.from_corpus(x[:n0], cfg, key=jax.random.PRNGKey(1))
    ann = StreamingANN(store=ST.grow(ann.store, n0 + SERVE_WB * (SERVE_EVENTS + 2) + 1),
                       cfg=cfg)

    def recall():
        st = ann.store
        valid = ST.active_mask(st)
        _, gt = E.ground_truth(st.x, q, k=10, valid=valid)
        return float(E.recall_topk(ann.search(q, scfg)[0], gt, valid=valid))

    before = recall()
    warm, writes = serving_script(n0, SERVE_WB, SERVE_EVENTS, SERVE_REQ)
    for op, arg in warm:
        if op == "ins":
            ann.insert(pool[arg])
        else:
            ann.delete(arg)
    clock = ManualClock()
    fe = ServingFrontend(ann, ServingConfig(
        admission=AdmissionConfig(tile_lanes=SERVE_TILE),
        writer=WriterConfig(insert_batch=SERVE_WB, delete_batch=SERVE_WB), search=scfg),
        clock=clock)
    w = 0
    for i in range(SERVE_REQ):
        fe.submit(q_np[i % q_np.shape[0]], deadline_s=SERVE_DEADLINE)
        while w < len(writes) and writes[w][0] <= i:
            _, kind, arg = writes[w]
            if kind == "insert":
                fe.submit_insert(pool[arg])
            else:
                fe.submit_delete(arg)
            w += 1
        clock.t += 1 / 200
        fe.pump()
    fe.drain()
    summ = fe.telemetry.summary()
    print(json.dumps({"mode": "serve", "pool": int(x.shape[0]), "n0": n0,
                      "requests": SERVE_REQ, "completed": summ["completed"],
                      "rows_written": summ["rows_written"], "tiles": summ["tiles"],
                      "recall_before": before, "recall_after": recall(),
                      "seconds": time.perf_counter() - t0}), flush=True)


def main(modes) -> None:
    data = {}
    for mode in modes:
        if mode in ("churn", "serve"):
            churn() if mode == "churn" else serve()
            continue
        kind = "gist" if mode == "gist" else mode in BUILDERS
        if kind not in data:
            data[kind] = corpus(mode in BUILDERS, gist=mode == "gist")
        x, q, gt, ep = data[kind]
        quant = QUANTS.get(mode, Quantization())
        t0 = time.perf_counter()
        if mode in BUILDERS:
            g = BUILDERS[mode](x, jax.random.PRNGKey(1))
        else:
            g = rd.build(x, dataclasses.replace(FULL, quant=quant), jax.random.PRNGKey(1))
        qx = encode_corpus(x, quant) if quant.is_coded else None
        cfg = dataclasses.replace(SEARCH, topk=10, quant=quant)
        ids, _ = S.search_tiled(x, g, q, ep, cfg, tile_b=q.shape[0], qx=qx)
        print(json.dumps({"mode": mode, "n": int(x.shape[0]), "d": int(x.shape[1]),
                          "queries": int(q.shape[0]),
                          "recall_at_10": float(E.recall_topk(ids, gt)),
                          "recall_at_1": float(E.recall_at_k(ids, gt)),
                          "avg_out_degree": E.degree_stats(g)["avg_out_degree"],
                          "connectivity": float(E.connectivity_lower_bound(g, int(ep))),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or [*QUANTS, *BUILDERS])
