"""Compare the three builders on the PyTorch/CUDA port (the paper's Figures 2
and 3 in miniature): construction time and the QPS/recall trade-off on one
corpus, served through the constant-memory tiled search; then the sharded,
streaming, serving, coded and traced forms of the same index.

    PYTHONPATH=src python examples/torch_build_and_search.py [--device cuda|cpu] [--n 6000]
        [--queries 400] [--ranks N] [--trace PATH]

The port of ``examples/build_and_search.py`` (its docstring explains each
part). It runs on the card unless ``--device cpu`` is given (then every
kernel runs its plain PyTorch version); without a card and without
``--device cpu`` it raises.

Search kernel: on the card the beam loop's gather+score is one launch of
the hand-written ``beam_score`` kernel an iteration (``kernels/csrc``); a
CPU tensor runs its plain version. The two are held equal by the card
tests. Scaling out: where the reference forges XLA host devices, ``--ranks
N`` spawns N gloo ranks on this machine (``launch.mesh.spawn``); the
sharded build and both search shardings must return the single device's
graph and ids exactly.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import eval as E
from repro_torch.core import graph as G
from repro_torch.core import nn_descent as nnd
from repro_torch.core import nsg_style
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import mesh as M

RNND = rd.RNNDescentConfig(s=12, r=48, t1=4, t2=6, capacity=64)


def sharded_parity(rank, world, x, q, entry, scfg, graph, ids_1):
    """One rank: the row-sharded build and the query- and corpus-sharded
    searches, each equal to the single device's."""
    mesh = M.make_mesh((world,), ("data",), backend="gloo", device=x.device)
    gen = torch.Generator(device=x.device).manual_seed(1)
    g = rd.build(x, RNND, gen, mesh=mesh)
    if not torch.equal(g.neighbors, graph.neighbors):
        raise RuntimeError("the sharded build diverged")
    ids_m, _ = S.search_tiled(x, graph, q, entry, scfg, tile_b=128, mesh=mesh)
    ids_c, _ = S.search_tiled(x, graph, q, entry, scfg, tile_b=128, mesh=mesh, shard="corpus")
    if not (torch.equal(ids_m, ids_1) and torch.equal(ids_c, ids_1)):
        raise RuntimeError("a sharded search diverged")
    if rank == 0:
        n, d = x.shape
        row = d * 4 + graph.neighbors.shape[1] * 9           # f32 row + adjacency + dists/flags
        print(f"sharded[{world} gloo ranks]      build parity True  search parity True  "
              f"corpus-sharded parity True  resident/rank {n * row // 1024} KiB -> "
              f"{-(-n // world) * row // 1024} KiB", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--ranks", type=int, default=0, help="gloo ranks for the sharded part")
    ap.add_argument("--trace", default=os.path.join(tempfile.gettempdir(), "ann_trace.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    x, q = clustered_vectors(VectorDatasetSpec("demo", n=args.n, d=96, n_queries=args.queries,
                                               n_clusters=48), gen(0), dev)
    n = x.shape[0]
    _, gt = E.ground_truth(x, q, k=1)
    entry = S.default_entry_point(x)
    scfg = S.SearchConfig(l=48, k=32, max_iters=128)

    # every builder defaults to merge="bucketed"; merge="sort" is the exact oracle
    builders = {
        "rnn-descent": lambda: rd.build(x, RNND, gen(1)),
        "rnn-descent[sort-oracle]": lambda: rd.build(
            x, dataclasses.replace(RNND, merge="sort"), gen(1)),
        "nn-descent": lambda: nnd.build(x, nnd.NNDescentConfig(k=32, s=12, iters=8), gen(1)),
        "nsg-style": lambda: nsg_style.build(
            x, nsg_style.NSGStyleConfig(r=24, c=64, knn=nnd.NNDescentConfig(k=32, s=12, iters=8)),
            gen(1)),
    }
    results, graph = {}, None
    for name, build in builders.items():
        build()                               # warm: kernel builds, allocator
        sync()
        t0 = time.perf_counter()
        g = build()
        sync()
        sec = time.perf_counter() - t0
        stats = E.evaluate_search(x, g, q, gt, scfg, entry_points=entry, tile_b=128)
        results[name] = stats["recall_at_1"]
        print(f"{name:24s} build {sec:6.2f}s  recall@1 {stats['recall_at_1']:.4f}  "
              f"qps {stats['qps']:8.1f}  visited/tile "
              f"{stats['visited_bytes_per_tile'] / 1024:.0f} KiB  "
              f"avg-out-degree {float(G.average_out_degree(g)):.1f}")
        if name == "rnn-descent":
            graph = g

    # the beam kernel on the rnn-descent graph: its launches, and the same search
    # on CPU copies through the plain versions
    reset_launches()
    stats = E.evaluate_search(x, graph, q, gt, scfg, entry_points=entry, tile_b=128, repeats=1)
    print(f"search[{stats['search_path']:12s}]       recall@1 {stats['recall_at_1']:.4f}  "
          f"qps {stats['qps']:8.1f}  beam_score launches {LAUNCHES['beam_score']}")
    if dev.type == "cuda":
        cpu_g = G.Graph(*(t.cpu() for t in graph))
        stats = E.evaluate_search(x.cpu(), cpu_g, q.cpu(), gt.cpu(), scfg,
                                  entry_points=entry.cpu(), tile_b=128, repeats=1)
        print(f"search[{stats['search_path']:12s}]       recall@1 {stats['recall_at_1']:.4f}  "
              f"qps {stats['qps']:8.1f}")

    # scaling out: sharded build + sharded serving over gloo ranks
    ids_1, _ = S.search_tiled(x, graph, q, entry, scfg, tile_b=128)
    if args.ranks:
        M.spawn(sharded_parity, args.ranks, (x, q, entry, scfg, graph, ids_1), backend="gloo")
    else:
        print("sharded: pass --ranks N to run the sharded build and search over N gloo ranks")

    # streaming churn: insert a sixth more points, delete a twelfth of the
    # originals without a rebuild, then serve tombstone-aware
    from repro_torch.streaming import StreamingANN, StreamingConfig
    from repro_torch.streaming.store import active_mask

    n0 = n * 5 // 6
    ann = StreamingANN.from_corpus(x[:n0], StreamingConfig(build=RNND), generator=gen(1))
    t0 = time.perf_counter()
    ann.insert(x[n0:])
    sync()
    ins_sec = time.perf_counter() - t0
    ann.delete(np.arange(n0 // 10))
    live = active_mask(ann.store)
    _, gt_si = E.ground_truth(ann.store.x, q, k=10, valid=live)
    ids_s, _ = ann.search(q, dataclasses.replace(scfg, topk=10))
    print(f"streaming churn           +{n - n0} pts in {ins_sec:5.2f}s  -{n0 // 10} tombstoned  "
          f"recall@10 {E.recall_topk(ids_s, gt_si, valid=live):.4f}  epoch {ann.epoch}")

    # serving front end: a short open-loop session against the churned index,
    # two write bursts committing mid-stream behind the epoch swap
    from repro_torch.serving import (AdmissionConfig, LoadSpec, ServingConfig,
                                     ServingFrontend, WriterConfig, run_session)

    srv_cfg = ServingConfig(admission=AdmissionConfig(tile_lanes=32, deadline_s=1.5),
                            writer=WriterConfig(insert_batch=32, delete_batch=32),
                            search=dataclasses.replace(scfg, topk=10))
    fe = ServingFrontend(ann, srv_cfg)          # warm one tile and one commit round
    q_np, x_np = q.cpu().numpy(), x.cpu().numpy()
    for row in q_np[:32]:
        fe.submit(row)
    wtk = fe.submit_insert(x_np[:32])
    fe.drain()
    ann.delete(wtk.ids)                         # retire the warm rows
    fe = ServingFrontend(ann, srv_cfg)          # fresh SLO telemetry
    writes = [(64, "insert", x_np[:32]), (128, "delete", np.arange(600, 632) % n0)]
    summ = run_session(fe, q_np, LoadSpec(n_requests=min(256, 2 * len(q_np)), qps=32.0,
                                          deadline_s=1.5), writes=writes)
    lat = summ["latency_ms"]
    print(f"serving session           {summ['completed']} reqs  p50 {lat['p50']:6.1f}ms  "
          f"p99 {lat['p99']:6.1f}ms  qps {summ['achieved_qps']:7.1f}  occupancy "
          f"{summ['occupancy_mean']:.2f}  staleness_max {summ['staleness_max']}  "
          f"epoch {ann.epoch}")

    # compressed corpora: serve the rnn-descent graph from int8 and PQ codes
    from repro_torch.quant import Quantization, corpus_bytes, encode_corpus

    r1_f32 = results["rnn-descent"]
    for quant in (Quantization(mode="int8"), Quantization(mode="pq", m=24)):
        qx = encode_corpus(x, quant)
        mem = corpus_bytes(qx, n, x.shape[1])
        ids_q, _ = S.search_tiled(x, graph, q, entry, dataclasses.replace(scfg, quant=quant),
                                  tile_b=128, qx=qx)
        print(f"quantized[{quant.mode:4s}]          recall@1 {E.recall_at_k(ids_q, gt):.4f} "
              f"(f32 {r1_f32:.4f})  payload {mem['payload_ratio']:.0f}x smaller  aux "
              f"{mem['aux_bytes'] / 1024:.0f} KiB")

    # traced build: the same rnn-descent build with obs on gives the same
    # graph bit for bit, its sweeps on one timeline
    from repro_torch import obs
    from repro_torch.obs import trace

    obs.enable()
    obs.reset()
    try:
        g_traced = rd.build(x, RNND, gen(1))
        if not torch.equal(g_traced.neighbors, graph.neighbors):
            raise RuntimeError("tracing changed a result bit")
        S.search_tiled(x, g_traced, q[:128], entry, scfg, tile_b=128)
        trace.write_chrome_trace(args.trace)
        print(f"\ntraced build phase breakdown (full timeline: {args.trace}):")
        print(trace.summary_table())
    finally:
        obs.disable()
    return {"recall_at_1": results, "n": n, "device": str(dev)}


if __name__ == "__main__":
    main()
