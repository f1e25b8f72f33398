"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: card name, power limit, versions; build every CUDA kernel from
     src/repro_torch/kernels/csrc (one nvcc per source, in parallel);
  2. medium path (n = 20k SIFT-like, paper build FULL, 500 queries, L = K = 64,
     top-10), once through the kernels and once through their plain PyTorch
     versions, both on the card, from one seed: recall@10, out-degree and
     connectivity bars, and the two runs within 0.01 recall of each other;
  3. main path at full size (n = 1M, d = 128, FULL; 10k queries; hashed
     search_tiled): launch counts are zeroed just before and read just after,
     and every kernel must have launched; then the dense-visited oracle at
     L = 64 (recall within 0.005 of the hashed run), recall/QPS at
     L = 128, 256, and a torch.profiler trace of the search (device busy
     time);
  4. each kernel against its plain version on the main path's shapes and
     data, timed with CUDA events (rounds of back-to-back calls, median
     round and spread) beside its bound and, where one exists, a single
     PyTorch call computing the same function;
  5. build-side witness: the same full-size build through the sort-oracle
     merge, whose recall and graph quality (share of sampled rows holding
     their exact nearest neighbours) must be no worse than the bucketed
     build's.
The last lines are the kernels' JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

F32_PEAK = 67e12     # H100 SXM f32 outside the tensor cores, FLOP/s (700 W)
HBM_RATE = 3.35e12   # H100 SXM HBM3, bytes/s
SEED = 0
FULL_N, FULL_Q = 1_000_000, 10_000
MEDIUM_N, MEDIUM_Q = 20_000, 500
REF_MEDIUM = {"recall_at_10": 0.998, "avg_out_degree": 12.5}  # reference package, CPU, n = 20k


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, inner: int, rounds: int = 5, warmup: int = 2) -> dict:
    """Per-call CUDA-event time of ``fn(i)``: ``rounds`` rounds of ``inner``
    back-to-back calls between one pair of events, after ``warmup`` calls.
    Returns the median round's per-call ms and the spread over rounds; ``i``
    lets a caller feed fresh inputs per call."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    per = []
    for r in range(rounds):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(inner):
            fn(warmup + r * inner + i)
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / inner)
    return {"ms": statistics.median(per), "ms_min": min(per), "ms_max": max(per),
            "calls": inner * rounds}


def device_ms(fn, calls: int, kernel_name: str) -> float | None:
    """Median device duration of the CUDA kernel whose name holds
    ``kernel_name`` over ``calls`` calls of ``fn(i)``, from a torch.profiler
    trace: the kernel's own time, free of host launch overhead."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    ts = [ev.time_range.end - ev.time_range.start for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA and kernel_name in ev.name]
    return statistics.median(ts) / 1e3 if ts else None


def _timed_keys(kernel: dict, plain: dict) -> dict:
    """The ``kernels`` line's time keys from two :func:`time_ms` results."""
    return {"ms": kernel["ms"], "plain_ms": plain["ms"],
            "ms_spread": [kernel["ms_min"], kernel["ms_max"], kernel["calls"]],
            "plain_ms_spread": [plain["ms_min"], plain["ms_max"], plain["calls"]]}


@contextlib.contextmanager
def plain_versions():
    """Route the path through the kernels' plain PyTorch versions on the
    card (the wrappers themselves only ever launch kernels on CUDA)."""
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.kernels.pairwise_l2 import ops as P
    from repro_torch.kernels.rng_prune import ops as R
    saved = (R.rng_prune, B.beam_score, P.pairwise_l2)
    R.rng_prune, B.beam_score, P.pairwise_l2 = R.rng_prune_plain, B.beam_score_ref, \
        P.pairwise_l2_ref
    try:
        yield
    finally:
        R.rng_prune, B.beam_score, P.pairwise_l2 = saved


@contextlib.contextmanager
def event_timed(module, names):
    """Wrap ``module.<name>`` for each name with CUDA events (no sync);
    yields {name: [ms, ...]} filled in on exit."""
    saved, events, out = {}, {n: [] for n in names}, {n: [] for n in names}
    for name in names:
        orig = saved[name] = getattr(module, name)

        def wrapper(*a, _orig=orig, _ev=events[name], **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            res = _orig(*a, **kw)
            e.record()
            _ev.append((s, e))
            return res
        setattr(module, name, wrapper)
    try:
        yield out
    finally:
        for name in names:
            setattr(module, name, saved[name])
        torch.cuda.synchronize()
        for name in names:
            out[name].extend(s.elapsed_time(e) for s, e in events[name])


def graph_quality(x, g, rows: int, gen_seed: int) -> dict:
    """Build-side witness: for ``rows`` sampled vertices, the share whose
    exact nearest neighbour is in its adjacency row (the RNG prune never
    drops a row's nearest candidate, so a miss means the descent never found
    it), and the mean share of the exact 10-NN in the row."""
    from repro_torch.core import eval as E
    n = x.shape[0]
    gen = torch.Generator(device=x.device).manual_seed(gen_seed)
    sample = torch.randperm(n, generator=gen, device=x.device)[:rows]
    _, knn = E.ground_truth(x, x[sample], k=11, tile=1024)
    self_hit = knn == sample[:, None].to(knn.dtype)
    check(bool(self_hit.any(dim=1).all()), "a sampled vertex is not its own nearest point")
    knn = knn[~self_hit].view(rows, 10)          # the exact 10-NN other than self
    row = g.neighbors[sample.long()]
    hit = (knn[:, :, None] == row[:, None, :]).any(dim=2)
    return {"sampled_rows": rows, "nn1_in_graph": float(hit[:, 0].float().mean()),
            "nn10_in_graph": float(hit.float().mean())}


def run_path(x, q, n_queries_tile: int, gen_seed: int, medium: bool,
             merge: str = "bucketed"):
    """Build (FULL), ground truth, hashed tiled search (SEARCH, top-10)."""
    from repro_torch.core import eval as E
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    cfg = rd.RNNDescentConfig(s=20, r=96, t1=4, t2=15, capacity=128,
                              chunk=4096 if medium else 512, merge=merge)
    scfg = S.SearchConfig(l=64, k=64, max_iters=256, topk=10)
    res = {}
    with event_timed(rd, ("prune_rows", "update_neighbors", "add_reverse_edges")) as ev:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = rd.build(x, cfg, torch.Generator(device=x.device).manual_seed(gen_seed))
        torch.cuda.synchronize()
        res["build_s"] = time.perf_counter() - t0
    res["prune_s"] = sum(ev["prune_rows"]) / 1e3
    res["merge_s"] = (sum(ev["update_neighbors"]) - sum(ev["prune_rows"])) / 1e3
    res["reverse_s"] = sum(ev["add_reverse_edges"]) / 1e3
    res["sweeps"] = len(ev["update_neighbors"])
    t0 = time.perf_counter()
    _, gt = E.ground_truth(x, q, k=10, tile=1024)
    torch.cuda.synchronize()
    res["gt_s"] = time.perf_counter() - t0
    ep = S.default_entry_point(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists, stats = S.search_tiled(x, g, q, ep, scfg, tile_b=n_queries_tile,
                                       with_stats=True)
    torch.cuda.synchronize()
    res["search_s"] = time.perf_counter() - t0
    res["qps"] = q.shape[0] / res["search_s"]
    check(ids.shape == (q.shape[0], 10) and dists.shape == ids.shape, "result shape")
    check(bool(((ids >= 0) & (ids < x.shape[0])).all()), "result ids out of range")
    check(bool(torch.isfinite(dists).all()), "non-finite result distance")
    check(bool((torch.diff(dists, dim=1) >= 0).all()), "results not sorted")
    check(bool((torch.sort(ids, dim=1).values.diff(dim=1) != 0).all()), "duplicate results")
    res["recall_at_10"] = E.recall_topk(ids, gt)
    res["recall_at_1"] = E.recall_at_k(ids, gt)
    res["avg_out_degree"] = E.degree_stats(g)["avg_out_degree"]
    res["connectivity"] = E.connectivity_lower_bound(g, int(ep))
    res["search_work"], res["search_launched"] = stats["work"], stats["launched"]
    return g, gt, ids, res


def medium_phase():
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels import LAUNCHES, reset_launches
    out = {}
    for route in ("kernel", "plain"):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x, q = clustered_vectors(VectorDatasetSpec.sift_like(MEDIUM_N, MEDIUM_Q), gen, "cuda")
        reset_launches()
        ctx = plain_versions() if route == "plain" else contextlib.nullcontext()
        with ctx:
            g, _, _, res = run_path(x, q, MEDIUM_Q, SEED + 1, medium=True)
        launches = res["launches"] = dict(LAUNCHES)
        if route == "plain":
            check(sum(launches.values()) == 0, "a kernel launched on the plain route")
        else:
            check(all(v > 0 for v in launches.values()), f"kernel not launched: {launches}")
        res.update(graph_quality(x, g, 10_000, SEED + 11))
        emit({"phase": "medium", "route": route, "n": MEDIUM_N, "queries": MEDIUM_Q, **res})
        check(res["recall_at_10"] >= 0.97, f"{route}: recall@10 {res['recall_at_10']} < 0.97")
        check(abs(res["avg_out_degree"] - REF_MEDIUM["avg_out_degree"])
              <= 0.1 * REF_MEDIUM["avg_out_degree"], f"{route}: out-degree off by > 10 %")
        check(res["connectivity"] >= 0.99, f"{route}: connectivity {res['connectivity']}")
        out[route] = res
    delta = abs(out["kernel"]["recall_at_10"] - out["plain"]["recall_at_10"])
    check(delta <= 0.01, f"kernel vs plain recall@10 differ by {delta}")
    return out


def full_phase():
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels import LAUNCHES, reset_launches
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x, q = clustered_vectors(VectorDatasetSpec.sift_like(FULL_N, FULL_Q), gen, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    g, gt, ids, res = run_path(x, q, 1024, SEED + 1, medium=False)
    launches = dict(LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"kernel not launched: {launches}")
    res["launches"] = launches
    res["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res.update(graph_quality(x, g, 10_000, SEED + 11))
    emit({"phase": "path", "n": FULL_N, "d": 128, "queries": FULL_Q,
          "build": "FULL s=20 r=96 t1=4 t2=15 M=128", "search": "L=64 K=64 topk=10 hashed",
          "reduced": None, **res})
    # 0.801 on the committed code; the sort-oracle build below must agree
    check(res["recall_at_10"] >= 0.78, f"full-size recall@10 {res['recall_at_10']}")
    search_checks(x, q, g, gt, ids, res["recall_at_10"])
    search_trace(x, q, g, res["search_s"])
    return x, q, g, launches, res


def sort_oracle_build(x, q, res):
    """Build-side witness at full size: the same build from the same seed
    through the sort-oracle merge (global lexsorts over the edge list). The
    bucketed merge keeps one candidate per hashed slot, so it may only lose
    candidates: the oracle's graph must be at least as good."""
    g, _, _, srt = run_path(x, q, 1024, SEED + 1, medium=False, merge="sort")
    srt.update(graph_quality(x, g, 10_000, SEED + 11))
    emit({"phase": "sort_oracle", "n": FULL_N, **srt,
          "bucketed": {k: res[k] for k in ("recall_at_10", "recall_at_1", "avg_out_degree",
                                           "nn1_in_graph", "nn10_in_graph", "build_s")}})
    check(srt["connectivity"] >= 0.99, f"sort-oracle connectivity {srt['connectivity']}")
    for key in ("recall_at_10", "nn1_in_graph", "nn10_in_graph"):
        check(srt[key] >= res[key] - 0.01, f"sort-oracle {key} {srt[key]} < bucketed {res[key]}")


def search_trace(x, q, g, search_s):
    """The main path's search (L = 64, hashed, 10k queries) under
    torch.profiler: device busy time against the untraced run's wall time,
    and the share of the beam_score kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import search as S
    cfg = S.SearchConfig(l=64, k=64, max_iters=256, topk=10)
    ep = S.default_entry_point(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.search_tiled(x, g, q, ep, cfg, tile_b=1024)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    spans, per_name = [], {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            a, b = ev.time_range.start, ev.time_range.end
            spans.append((a, b))
            per_name.setdefault(ev.name, [0.0, 0])
            per_name[ev.name][0] += (b - a) / 1e3
            per_name[ev.name][1] += 1
    busy_ms, end = 0.0, float("-inf")
    for a, b in sorted(spans):         # union of device intervals, in us
        if b > end:
            busy_ms += (b - max(a, end)) / 1e3
            end = b
    beam = [v for k, v in per_name.items() if "beam_score" in k]
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    emit({"phase": "search_trace", "device_events": len(spans),
          "device_busy_ms": busy_ms if spans else None,
          "traced_wall_ms": 1e3 * traced_s, "untraced_wall_ms": 1e3 * search_s,
          "idle_share_of_untraced_wall": 1 - busy_ms / (1e3 * search_s) if spans else None,
          "beam_score_ms": sum(v[0] for v in beam) if beam else None,
          "beam_score_launches": sum(v[1] for v in beam) if beam else None,
          "top_device_ms": [[k[:60], v[0], v[1]] for k, v in top]})


def search_checks(x, q, g, gt, ids, recall):
    """After the main path: the dense-visited oracle at L = 64 (the hashed
    table may lose inserts, never results), and recall/QPS at wider beams."""
    from repro_torch.core import eval as E
    from repro_torch.core import search as S
    ep = S.default_entry_point(x)
    for l, visited in ((64, "dense"), (128, "hashed"), (256, "hashed")):
        cfg = S.SearchConfig(l=l, k=64, max_iters=256, topk=10, visited=visited)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = S.search_tiled(x, g, q, ep, cfg, tile_b=1024)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        r = E.recall_topk(out, gt)
        row = {"phase": "search", "L": l, "K": 64, "visited": visited, "qps": q.shape[0] / sec,
               "recall_at_10": r, "recall_at_1": E.recall_at_k(out, gt)}
        if visited == "dense":
            same = float((out == ids).all(dim=1).float().mean())
            row["rows_equal_to_hashed"] = same
            check(abs(r - recall) <= 0.005, f"dense recall {r} vs hashed {recall}")
        emit(row)


def kernel_phase(x, q, g, launches):
    """Each kernel beside its plain version on the main path's data."""
    from repro_torch.core import graph as G
    from repro_torch.core import rnn_descent as rd
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.kernels.pairwise_l2 import ops as P
    from repro_torch.kernels.rng_prune import ops as R
    n, d = x.shape
    rows = 8192
    # the first 8192 rows of the built graph: the next sweep's prune input
    # (kept entries OLD, replacement edges NEW)
    ids, dists, flags = (t[:rows].contiguous() for t in g)
    report = []

    # -- rng_prune: integer-valued corpus first (exact), then the real one
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    xi = torch.randint(-8, 9, (n, d), generator=gen, device="cuda").float()
    src = torch.arange(rows, device="cuda", dtype=torch.int32)[:, None].expand(rows, ids.shape[1])
    di = G.D.gather_dists(xi, src.reshape(-1), ids.reshape(-1), "l2").reshape(rows, -1)
    for metric in ("l2", "ip"):
        ker = R.rng_prune(xi, ids, di, flags, metric)
        ref = R.rng_prune_plain(xi, ids, di, flags, metric, chunk=1024)
        check(all(torch.equal(a, b) for a, b in zip(ker, ref)),
              f"rng_prune integer-valued {metric}: kernel != plain")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        xx = x.to(dtype)
        for metric in ("l2", "ip", "cos"):
            ker = R.rng_prune(xx, ids, dists, flags, metric)
            ref = R.rng_prune_plain(xx, ids, dists, flags, metric, chunk=1024)
            agree = float((ker[0] == ref[0]).float().mean())
            w_agree = float((ker[1] == ref[1]).float().mean())
            same = (ker[1] == ref[1]) & (ker[1] >= 0)
            err = float((ker[2] - ref[2])[same].abs().max()) if bool(same.any()) else 0.0
            emit({"kernel": "rng_prune", "dtype": str(dtype), "metric": metric,
                  "rows": rows, "M": ids.shape[1], "d": d, "keep_agree": agree,
                  "red_w_agree": w_agree, "red_d_max_abs_err": err})
            check(agree >= 0.999, f"rng_prune {dtype} {metric}: keep agreement {agree}")
            check(w_agree >= 0.999, f"rng_prune {dtype} {metric}: red_w agreement {w_agree}")
            worst[(dtype, metric)] = err
    # l2 pair distances cancel (|a|^2 + |b|^2 - 2ab): tolerance scaled by the
    # norms. Kernel and plain version read the same (bf16 or f32) inputs and
    # both accumulate in f32, so bf16 is held to the f32 limit; ip scales with
    # |a||b| <= max|x|^2, cos is bounded by 2.
    sq = (x * x).sum(1)
    scale = 2 * float(sq.max())
    for (dtype, metric), err in worst.items():
        lim = 1e-5 * (2.0 if metric == "cos" else scale)
        check(err <= lim, f"rng_prune {dtype} {metric}: red_d error {err} > {lim}")
    valid = (ids >= 0).sum(1).double()
    flops = float((2 * valid * valid * d).sum())
    byts = float(valid.sum()) * d * 4 + rows * ids.shape[1] * 18
    report.append({
        "name": "rng_prune", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rng_prune.cu",
        "replaces": "src/repro/kernels/rng_prune/kernel.py:161",
        "launches": launches["rng_prune"], "max_abs_err": worst[(torch.float32, "l2")],
        "tolerance": f"keep, red_w agreement >= 0.999; red_d <= 1e-5 * 2 max|x|^2 = "
                     f"{1e-5 * scale:.3g} (f32 and bf16)",
        **_timed_keys(time_ms(lambda i: R.rng_prune(x, ids, dists, flags, "l2"), inner=20),
                      time_ms(lambda i: R.rng_prune_plain(x, ids, dists, flags, "l2", 1024),
                              inner=1, rounds=3, warmup=1)),
        "bound_ms": 1e3 * max(flops / F32_PEAK, byts / HBM_RATE),
        "bound_by": "operations" if flops / F32_PEAK > byts / HBM_RATE else "bytes",
        "device_ms": device_ms(lambda i: R.rng_prune(x, ids, dists, flags, "l2"), 20,
                               "rng_prune_kernel"),
        "library_ms": None, "shape": {"rows": rows, "M": ids.shape[1], "d": d}})

    # -- beam_score: B = 1024 frontier ids over the real graph, k = 64; every
    # timed call gets fresh frontier ids so the gathers are not L2-resident
    b, k, n_us = 1024, 64, 200
    us = [torch.randint(0, n, (b,), generator=gen, device="cuda", dtype=torch.int32)
          for _ in range(n_us)]
    qb = q[:b].contiguous()
    qs = float((qb * qb).sum(1).max()) + float(sq.max())
    # l2 cancels as above; ip scales with |q||x| <= (|q|^2 + |x|^2) / 2;
    # cos is bounded by 2
    lims = {"l2": 1e-5 * qs, "ip": 1e-5 * qs, "cos": 2e-5}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xx = x.to(dtype)
        for metric in ("l2", "ip", "cos"):
            ki, kd, kk = B.beam_score(xx, g.neighbors, us[0], qb, k, metric)
            ri, rd_, _ = B.beam_score_ref(xx, g.neighbors, us[0], qb, k, metric)
            check(torch.equal(ki, ri), f"beam_score {dtype} {metric}: ids differ")
            check(torch.equal(G.key_dist(kk), kd), "beam_score: dists do not decode from keys")
            fin = torch.isfinite(rd_)
            check(torch.equal(fin, torch.isfinite(kd)), "beam_score: padding differs")
            err = float((kd - rd_)[fin].abs().max()) if bool(fin.any()) else 0.0
            errs[(dtype, metric)] = err
            emit({"kernel": "beam_score", "dtype": str(dtype), "metric": metric, "B": b,
                  "k": k, "d": d, "max_abs_err": err, "limit": lims[metric]})
            check(err <= lims[metric], f"beam_score {dtype} {metric}: dists error {err}")
    nvalid = float((g.neighbors[us[0].long()][:, :k] >= 0).sum())
    flops = 4.0 * nvalid * d
    byts = nvalid * d * 4 + b * k * 4 + b * d * 4 + b * 4 + b * k * 12
    report.append({
        "name": "beam_score", "route": "cuda", "source": "src/repro_torch/kernels/csrc/beam_score.cu",
        "replaces": "src/repro/kernels/beam_score/kernel.py:196",
        "launches": launches["beam_score"], "max_abs_err": errs[(torch.float32, "l2")],
        "tolerance": f"ids exact; dists <= 1e-5 * (|q|^2 + |x|^2) = {1e-5 * qs:.3g} "
                     "(l2, ip; f32 and bf16), 2e-5 (cos)",
        **_timed_keys(
            time_ms(lambda i: B.beam_score(x, g.neighbors, us[i % n_us], qb, k, "l2"),
                    inner=n_us),
            time_ms(lambda i: B.beam_score_ref(x, g.neighbors, us[i % n_us], qb, k, "l2"),
                    inner=n_us)),
        "bound_ms": 1e3 * max(flops / F32_PEAK, byts / HBM_RATE),
        "bound_by": "operations" if flops / F32_PEAK > byts / HBM_RATE else "bytes",
        "device_ms": device_ms(
            lambda i: B.beam_score(x, g.neighbors, us[i % n_us], qb, k, "l2"), n_us,
            "beam_score_kernel"),
        "library_ms": None, "shape": {"B": b, "k": k, "M": g.capacity, "d": d, "n": n}})

    # -- pairwise_l2: 1024 queries x the 1M corpus x 128
    qa = q[:1024].contiguous()
    ker = P.pairwise_l2(qa, x)
    ref = P.pairwise_l2_ref(qa, x)
    scale = (qa * qa).sum(1)[:, None] + sq[None, :]
    rel = float(((ker - ref).abs() / scale).max())
    err = float((ker - ref).abs().max())
    del ker, ref, scale
    check(rel <= 1e-5, f"pairwise_l2: error {rel} of |a|^2 + |b|^2")
    ai = xi[:1024].contiguous()
    check(torch.equal(P.pairwise_l2(ai, xi[:100_000]), P.pairwise_l2_ref(ai, xi[:100_000])),
          "pairwise_l2 integer-valued: kernel != plain")
    emit({"kernel": "pairwise_l2", "na": 1024, "nb": n, "d": d, "max_abs_err": err,
          "max_err_over_norms": rel})
    flops = 2.0 * 1024 * n * d
    byts = (1024 * d + n * d + 1024 * n) * 4.0
    report.append({
        "name": "pairwise_l2", "route": "cuda", "source": "src/repro_torch/kernels/csrc/pairwise_l2.cu",
        "replaces": "src/repro/kernels/pairwise_l2/kernel.py:48",
        "launches": launches["pairwise_l2"], "max_abs_err": err,
        "tolerance": "|err| <= 1e-5 * (|a|^2 + |b|^2)",
        **_timed_keys(time_ms(lambda i: P.pairwise_l2(qa, x), inner=5),
                      time_ms(lambda i: P.pairwise_l2_ref(qa, x), inner=5)),
        "bound_ms": 1e3 * max(flops / F32_PEAK, byts / HBM_RATE),
        "bound_by": "operations" if flops / F32_PEAK > byts / HBM_RATE else "bytes",
        "device_ms": device_ms(lambda i: P.pairwise_l2(qa, x), 5, "pairwise_l2_kernel"),
        "library_ms": time_ms(lambda i: torch.cdist(qa, x), inner=5)["ms"],
        "library_call": "torch.cdist (Euclidean, i.e. the square root of the same matrix)",
        "shape": {"na": 1024, "nb": n, "d": d}})
    return report


def warm_up() -> None:
    """One tiny launch of each kernel: loads its module, so no phase's
    timing pays for that."""
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.kernels.pairwise_l2 import ops as P
    from repro_torch.kernels.rng_prune import ops as R
    x = torch.zeros(4, 8, device="cuda")
    ids = torch.tensor([[1, 2], [0, -1], [3, 0], [-1, -1]], dtype=torch.int32, device="cuda")
    R.rng_prune(x, ids, torch.zeros(4, 2, device="cuda"))
    B.beam_score(x, ids, ids[:, 0].clamp(min=0).contiguous(), x, 2)
    P.pairwise_l2(x, x)
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    built = _build.build_all()
    emit({"phase": "build", "seconds": built["seconds"], "kernels": list(_build.KERNELS)})
    for name, log in built["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    warm_up()
    t0 = time.perf_counter()
    medium_phase()
    x, q, g, launches, res = full_phase()
    report = kernel_phase(x, q, g, launches)
    del g
    sort_oracle_build(x, q, res)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": report})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
