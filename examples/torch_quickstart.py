"""Quickstart on the PyTorch/CUDA port: build an RNN-Descent index and search
it (the paper in ~30 lines), then stream updates into it, serve it and
search it over coded corpora.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu] [--n 8000]
        [--queries 500] [--ranks N]

The port of ``examples/quickstart.py``. It runs on the card unless
``--device cpu`` is given (then every kernel runs its plain PyTorch
version); without a card and without ``--device cpu`` it raises. ``--ranks
N`` runs the sharded search over N gloo ranks spawned on this machine.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import eval as E
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import mesh as M


def sharded_search(rank, world, x, graph, queries, entry, scfg, want_ids):
    """One rank of the sharded search: query tiles split over the ranks,
    the results gathered on every rank, equal to the unsharded search's."""
    mesh = M.make_mesh((world,), ("data",), backend="gloo", device=x.device)
    ids, _ = S.search_tiled(x, graph, queries, entry, scfg, tile_b=128, mesh=mesh)
    if not torch.equal(ids, want_ids):
        raise RuntimeError(f"rank {rank}: the sharded search differs from the unsharded one")
    if rank == 0:
        print(f"  sharded serving ({world} gloo ranks): recall@1 equal to unsharded", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=8000, help="corpus rows")
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--ranks", type=int, default=0, help="gloo ranks for the sharded search")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)

    # 1. a corpus (SIFT-like dims at laptop scale) + queries + exact ground truth
    x, queries = clustered_vectors(
        VectorDatasetSpec("demo", n=n, d=128, n_queries=args.queries, n_clusters=64),
        gen(0), dev)
    _, gt = E.ground_truth(x, queries, k=1)

    # 2. build the index: paper Algorithm 6 (S, R, T1, T2 scaled to corpus size),
    # every sweep's RNG prune through the hand-written rng_prune kernel
    cfg = rd.RNNDescentConfig(s=12, r=48, t1=4, t2=6, capacity=64)
    t0 = time.perf_counter()
    graph = rd.build(x, cfg, gen(1))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"built RNN-Descent index for n={n} in {time.perf_counter() - t0:.2f}s on {dev}")

    # 3. serve: paper Algorithm 1 with the query-time out-degree limit K (Eq. 4),
    # streamed through the constant-memory tiled driver (hashed visited state)
    entry = S.default_entry_points(x, n_entries=4, generator=gen(2))[None, :] \
        .expand(queries.shape[0], 4).contiguous()                 # multi-entry seeding (B, E)
    recalls = {}
    for L in (16, 32, 64):
        scfg = S.SearchConfig(l=L, k=32, max_iters=2 * L + 32)
        ids, _ = S.search_tiled(x, graph, queries, entry, scfg, tile_b=128)
        recalls[L] = E.recall_at_k(ids, gt)
        bytes_tile = S.visited_state_bytes(scfg, n, 128, n_entry=4)
        print(f"  L={L:3d}  recall@1={recalls[L]:.4f}  "
              f"visited-state/tile={bytes_tile / 1024:.0f} KiB")

    # 4. the beam inner loop: on the card each iteration's gather+score is one
    # launch of the hand-written beam_score kernel; on the CPU its plain version
    scfg = S.SearchConfig(l=32, k=32, max_iters=96)
    reset_launches()
    ids_f, _ = S.search_tiled(x, graph, queries, entry, scfg, tile_b=128)
    print(f"  beam kernel: recall@1={E.recall_at_k(ids_f, gt):.4f}, "
          f"{LAUNCHES['beam_score']} beam_score launches")

    # 5. scale out: the same search over gloo ranks returns exactly the same ids
    if args.ranks:
        M.spawn(sharded_search, args.ranks, (x, graph, queries, entry, scfg, ids_f),
                backend="gloo")
    else:
        print("  sharded serving: pass --ranks N to run it over N gloo ranks")

    # 6. streaming updates: insert() beam-seeds new rows off the current graph
    # and runs localized RNN-Descent sweeps; delete() tombstones rows (still
    # traversable, never surfaced) and splices their neighbours together
    from repro_torch.streaming import StreamingANN, StreamingConfig
    from repro_torch.streaming.store import active_mask

    n0, gone = n * 7 // 8, n // 16
    ann = StreamingANN.from_corpus(x[:n0], StreamingConfig(build=cfg), generator=gen(1))
    ann.insert(x[n0:])                               # new points, no rebuild
    ann.delete(np.arange(gone))                      # originals, tombstoned
    dense = S.SearchConfig(l=32, k=32, max_iters=96, topk=10, visited="dense")
    ids_s, _ = ann.search(queries, dense)
    live = active_mask(ann.store)
    _, gt_si = E.ground_truth(ann.store.x, queries, k=10, valid=live)
    print(f"  streaming churn (+{n - n0}/-{gone}): recall@10="
          f"{E.recall_topk(ids_s, gt_si, valid=live):.4f}  epoch={ann.epoch}  "
          f"live={ann.live}/{ann.capacity} rows")
    if bool(torch.isin(ids_s, torch.arange(gone, device=ids_s.device)).any()):
        raise RuntimeError("a deleted row surfaced in a search")

    # 7. serve it: the admission queue coalesces arriving queries into
    # fixed-shape search tiles, writes batch behind the epoch swap; dense
    # visited makes a result a function of (query, epoch) on the card too
    from repro_torch.serving import AdmissionConfig, ServingConfig, ServingFrontend

    fe = ServingFrontend(ann, ServingConfig(
        admission=AdmissionConfig(tile_lanes=32, deadline_s=0.2), search=dense))
    rids = [fe.submit(row) for row in queries[:48].cpu().numpy()]
    tk = fe.submit_insert(x[:32].cpu().numpy())     # rides the next full batch
    fe.drain()
    first_ids, _ = fe.result(rids[0])
    summ = fe.telemetry.summary()
    print(f"  serving: {summ['completed']} requests in {summ['tiles']} tiles  "
          f"p50={summ['latency_ms']['p50']:.1f}ms  occupancy={summ['occupancy_mean']:.2f}  "
          f"insert ticket -> rows {tk.ids[:3]}...")
    if not np.array_equal(np.asarray(first_ids), ids_s[0].cpu().numpy()):
        raise RuntimeError("the served result differs from the same store's search")

    # 8. compressed corpus: int8 or PQ codes instead of f32 rows, decoded in
    # registers by the coded beam kernels, then an exact-f32 rerank tail
    from repro_torch.quant import Quantization, corpus_bytes, encode_corpus

    for quant in (Quantization(mode="int8"), Quantization(mode="pq", m=32)):
        qx = encode_corpus(x, quant)
        mem = corpus_bytes(qx, n, x.shape[1])
        qcfg = dataclasses.replace(scfg, quant=quant)
        ids_q, _ = S.search_tiled(x, graph, queries, entry, qcfg, tile_b=128, qx=qx)
        print(f"  quantized[{quant.mode:4s}]: recall@1={E.recall_at_k(ids_q, gt):.4f}  payload "
              f"{mem['payload_ratio']:.0f}x smaller ({mem['codes_bytes'] / 2**20:.1f} MiB vs "
              f"{mem['f32_bytes'] / 2**20:.1f} MiB f32)")
    return {"recall_at_1": recalls, "n": n, "device": str(dev)}


if __name__ == "__main__":
    main()
