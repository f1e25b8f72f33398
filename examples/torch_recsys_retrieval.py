"""The paper's technique as a framework feature on the PyTorch/CUDA port:
candidate retrieval for a recsys model served two ways, brute-force scoring
against RNN-Descent graph traversal over the same candidate embeddings (the
``retrieval_cand`` cell).

    PYTHONPATH=src python examples/torch_recsys_retrieval.py [--device cuda|cpu]
        [--candidates 20000] [--queries 200]

The port of ``examples/recsys_retrieval.py``. It runs on the card unless
``--device cpu`` is given; without a card and without ``--device cpu`` it
raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.models.recsys import score_candidates

DIM = 64


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--candidates", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=200)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n_q = args.queries

    gen = torch.Generator(device=dev).manual_seed(0)
    cands = torch.randn((args.candidates, DIM), generator=gen, device=dev)
    cands = cands / torch.linalg.norm(cands, dim=1, keepdim=True)
    queries = cands[:n_q] + 0.1 * torch.randn((n_q, DIM), generator=gen, device=dev)

    # path 1: brute force (exact; the retrieval_cand cell's step), one query a call
    t0 = time.perf_counter()
    bf_ids = torch.stack([score_candidates(queries[i], cands, k=10)[1] for i in range(n_q)])
    sync()
    t_bf = time.perf_counter() - t0

    # path 2: an RNN-Descent index over the candidates (L2 on unit vectors ranks
    # as the dot product does)
    cfg = rd.RNNDescentConfig(s=12, r=48, t1=3, t2=5, capacity=64)
    t0 = time.perf_counter()
    g = rd.build(cands, cfg, torch.Generator(device=dev).manual_seed(2))
    sync()
    t_build = time.perf_counter() - t0
    entry = S.default_entry_point(cands)
    scfg = S.SearchConfig(l=32, k=32, max_iters=96, topk=10)
    S.search(cands, g, queries, entry, scfg)                  # warm
    sync()
    t0 = time.perf_counter()
    ids, _ = S.search(cands, g, queries, entry, scfg)
    sync()
    t_ann = time.perf_counter() - t0

    recall = float((ids == bf_ids[:, :1]).any(dim=1).float().mean())
    print(f"brute force : {n_q / t_bf:8.1f} QPS (exact)")
    print(f"rnn-descent : {n_q / t_ann:8.1f} QPS, recall@1-in-top10 {recall:.4f} "
          f"(build {t_build:.2f}s, amortized over every query)")
    return {"recall_at_1_in_top10": recall, "qps_brute_force": n_q / t_bf,
            "qps_ann": n_q / t_ann, "device": str(dev)}


if __name__ == "__main__":
    main()
