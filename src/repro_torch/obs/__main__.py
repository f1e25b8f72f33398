"""``python -m repro_torch.obs`` — scripted, self-checking observability
session (the port of ``python -m repro.obs``).

Runs one build + search + serve pass twice — first untraced (the
reference), then with the whole obs stack enabled — and writes what an
operator would pull from a deployment:

* ``trace.json`` — Chrome/Perfetto trace-event JSON covering the build
  sweeps (``rnn_descent/*``), the search (``search/tiled``), the serving
  request lifecycle (``serving/*`` pump spans and per-request tracks), and
  the kernel track (``kernel/build``: each nvcc run of the session);
* ``metrics.prom`` — Prometheus text exposition of the process registry;
* ``metrics.json`` — the same registry as a JSON snapshot.

It checks the two observability contracts and exits nonzero if either
fails:

1. **bit-for-bit parity** — the traced build's graph and the traced
   search's results equal the untraced ones (tracing adds host-side reads
   and synchronisations, never a different launch);
2. **zero steady-state builds** — after a warm-up that touches every
   steady-state shape (full search tile, both writer batch shapes, entry
   refresh), the measured serving session builds no kernel and opens no
   kernel library.

Plus a structural check that ``trace.json`` loads and covers the build,
search and serving span families; on the card also the kernel track where
the traced session built a kernel, else the device time of the build's
sweeps.

    python -m repro_torch.obs                      # on the card
    python -m repro_torch.obs --device cpu --out /tmp/obs
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _check(failures: list[str], ok: bool, label: str) -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {label}", flush=True)
    if not ok:
        failures.append(label)


def _validate_trace(path: str, failures: list[str], card: bool, built: bool) -> None:
    """Loadability + coverage check on the emitted Perfetto JSON. On the
    card (``card``): the kernel track where the session ran nvcc
    (``built``), else ``device_ms`` on every build sweep span."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    xs = [e for e in evs if e.get("ph") == "X"]
    _check(failures, bool(xs) and all(
        isinstance(e.get("ts"), (int, float)) and
        isinstance(e.get("dur"), (int, float)) and e.get("name")
        for e in xs), "trace.json is valid trace-event JSON")
    names = {e["name"] for e in xs}
    families = [("rnn_descent/", "build sweep spans"),
                ("search/", "search tile spans"),
                ("serving/", "serving pump spans"),
                ("request/", "per-request lifecycle spans")]
    if card and built:
        families.append(("kernel/build", "the kernel track"))
    for family, label in families:
        _check(failures, any(n.startswith(family) for n in names),
               f"trace covers {label} ({family}*)")
    if card and not built:
        sweeps = [e for e in xs if e["name"] == "rnn_descent/sweep"]
        _check(failures, bool(sweeps) and all("device_ms" in e.get("args", {})
                                              for e in sweeps),
               "build sweep spans carry their device time (device_ms)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="scripted build+search+serve session with tracing on; "
                    "writes trace.json + metrics.prom and self-checks the "
                    "bit-for-bit parity and zero-steady-build contracts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the session runs (default: cuda)")
    ap.add_argument("--out", default="obs_artifacts",
                    help="artifact directory (default: obs_artifacts)")
    ap.add_argument("--n", type=int, default=384,
                    help="corpus rows (default 384)")
    ap.add_argument("--d", type=int, default=32,
                    help="dimensions (default 32)")
    ap.add_argument("--requests", type=int, default=96,
                    help="serving session request count (default 96)")
    ap.add_argument("--qps", type=float, default=400.0,
                    help="offered load for the open-loop session")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.obs import cudahooks, metrics, trace
    from repro_torch.serving import (AdmissionConfig, LoadSpec, ServingConfig,
                                     ServingFrontend, WriterConfig, run_session)
    from repro_torch.streaming import StreamingANN, StreamingConfig
    from repro_torch.streaming import store as ST

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m repro_torch.obs: no CUDA device "
                           "(pass --device cpu to run the session on the CPU)")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    failures: list[str] = []
    os.makedirs(args.out, exist_ok=True)

    rng = np.random.default_rng(7)
    tile_lanes, wb, n_events = 32, 16, 2
    pool_rows = wb * (n_events + 2)
    x = rng.standard_normal((args.n + pool_rows, args.d)).astype(np.float32)
    q = rng.standard_normal((max(args.requests, tile_lanes),
                             args.d)).astype(np.float32)
    corpus, pool = x[:args.n], x[args.n:]
    cfg = StreamingConfig(
        build=rd.RNNDescentConfig(s=8, r=24, t1=3, t2=2, capacity=32,
                                  chunk=128),
        seed_l=32, seed_k=16, seed_iters=48, batch_k=4, sweeps=2,
        splice_k=6)
    scfg = S.SearchConfig(l=32, k=24, max_iters=96, topk=10)
    q_dev = torch.from_numpy(q).to(dev)

    def build_and_probe():
        gen = torch.Generator(device=dev).manual_seed(0)
        ann = StreamingANN.from_corpus(corpus, cfg, generator=gen, device=dev)
        _, st = ann.snapshot()
        eps = S.default_entry_point(st.x, scfg.metric,
                                    valid=ST.active_mask(st))
        ids, dists = ann.search(q_dev[:tile_lanes], scfg, entry_points=eps,
                                tile_b=tile_lanes, store=st)
        sync()
        return ann, ids.cpu().numpy(), dists.cpu().numpy()

    def graph_bytes(ann):
        g = ann.store.graph
        return tuple(t.cpu().numpy().tobytes() for t in g)

    # ---------------------------------------------------- untraced reference
    print("== reference run (tracing off) ==", flush=True)
    ann_ref, ids_ref, dists_ref = build_and_probe()
    ref_graph = graph_bytes(ann_ref)
    del ann_ref

    # ------------------------------------------------------------ traced run
    print("== traced run (obs enabled) ==", flush=True)
    obs.enable()
    obs.reset()
    traced_builds0 = cudahooks.kernel_builds()

    with trace.span("obs/build") as bsp, cudahooks.span_costs(bsp, dev):
        ann, ids_t, dists_t = build_and_probe()
        bsp.set(n=args.n, d=args.d, device=str(dev))
    cudahooks.record_memory(phase="build", device=dev)

    _check(failures, graph_bytes(ann) == ref_graph,
           "traced build graph bit for bit the untraced one")
    _check(failures, ids_t.tobytes() == ids_ref.tobytes()
           and dists_t.tobytes() == dists_ref.tobytes(),
           "traced search results bit for bit the untraced ones")

    # --------------------------------------------------------------- serving
    # pre-grow so no growth can land mid-session, then warm every
    # steady-state shape: full tile, both write batch shapes, entry refresh
    # at the post-update epoch
    ann = StreamingANN(store=ST.grow(ann.store, args.n + pool_rows + 1),
                       cfg=cfg)
    with trace.span("obs/warmup"):
        ann.insert(pool[:wb])
        ann.delete(np.arange(args.n - wb, args.n))
        _, st = ann.snapshot()
        eps = S.default_entry_point(st.x, scfg.metric,
                                    valid=ST.active_mask(st))
        ann.search(q_dev[:tile_lanes], scfg, entry_points=eps,
                   tile_b=tile_lanes,
                   lane_valid=torch.ones((tile_lanes,), dtype=torch.bool,
                                         device=dev),
                   store=st)
        sync()

    srv = ServingConfig(
        admission=AdmissionConfig(tile_lanes=tile_lanes),
        writer=WriterConfig(insert_batch=wb, delete_batch=wb),
        search=scfg)
    fe = ServingFrontend(ann, srv)
    writes = []
    for e in range(n_events):
        after = (e + 1) * args.requests // (n_events + 1)
        ins = pool[wb * (e + 1):wb * (e + 2)]
        dl = np.arange(args.n - wb * (e + 2), args.n - wb * (e + 1))
        writes += [(after, "insert", ins), (after, "delete", dl)]
    spec = LoadSpec(n_requests=args.requests, qps=args.qps, deadline_s=0.5,
                    arrival="poisson", seed=0)

    builds0, loads0 = cudahooks.kernel_builds(), cudahooks.kernel_libs_loaded()
    with trace.span("obs/serve_session"):
        summ = run_session(fe, q, spec, writes=writes)
    builds = cudahooks.kernel_builds() - builds0
    loads = cudahooks.kernel_libs_loaded() - loads0
    cudahooks.record_memory(phase="serve", device=dev)

    _check(failures, summ["completed"] == args.requests,
           f"serving session completed {summ['completed']}/{args.requests}")
    _check(failures, builds == 0 and loads == 0,
           f"zero steady-state kernel builds (saw {builds}) and library "
           f"loads (saw {loads})")

    # -------------------------------------------------------------- artifacts
    trace_path = os.path.join(args.out, "trace.json")
    trace.write_chrome_trace(trace_path, process_name="repro_torch.obs session")
    metrics.write_exposition(os.path.join(args.out, "metrics.prom"))
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(metrics.REGISTRY.snapshot(), f, indent=1)
    # kernels run, and are built, only on the card
    _validate_trace(trace_path, failures, card=dev.type == "cuda",
                    built=cudahooks.kernel_builds() > traced_builds0)
    obs.disable()

    print(f"\nartifacts: {trace_path} (open in https://ui.perfetto.dev), "
          f"metrics.prom, metrics.json")
    lat = summ["latency_ms"]
    print(f"serving: p50={lat['p50']:.2f}ms p95={lat['p95']:.2f}ms "
          f"qps={summ['achieved_qps']:.0f} "
          f"staleness_mean={summ['staleness_mean']}")
    print("\nspan summary:")
    print(trace.summary_table())

    if failures:
        print(f"\n{len(failures)} contract check(s) FAILED", file=sys.stderr)
        return 1
    print("\nall observability contracts hold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
