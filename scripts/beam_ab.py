"""Timing of the beam kernels on one card: per call and inside the 1M
searches, for one checkout's wrappers and kernels and for variants of their
CUDA sources.

    python3 scripts/beam_ab.py [--make] [--data build/beam_ab.pt] [--label L]
                               [--modes f32,bf16,wide,int8,pq]
                               [--variant NAME=FILE.cu ...]
                               [--out build/beam_ab.jsonl]

The script times the checkout it sits in (its ``src/`` and ``chip_smoke.py``).
``--make`` builds the data file first: the 1M graphs of the corpus modes
that ``--modes`` needs (f32 for f32, bf16 and wide; int8 and PQ with their
codes and codebooks) as chip_smoke.py's paths build them (its seed and FULL
build), and per corpus mode the frontier ids ``u`` of beam iteration
``chip_smoke.SNAP_ITER`` in the first tile's search, retired lanes -1. Every
later run loads that file, so two checkouts time the same inputs: copy this
script into the other checkout's ``scripts/`` and this ``chip_smoke.py``
(whose helpers it uses) into its root (say a parent commit unpacked with
``git archive`` under ``build/``) and run the two in turns, A, B, B, A, in
one call.

A ``--variant`` is a copy of ``csrc/beam_score.cu`` or ``csrc/beam_score_pq.cu``
with the same C entry points; all variants compile at once with the
package's nvcc flags, and the wrappers are routed through each in turn:
the checkout's own kernels, then the variants, then back in reverse order.

Modes (l2, B = 1024, k = 64): ``f32`` and ``bf16`` (``beam_score`` over the
1M f32 graph, rows in f32 or cast to bf16), ``wide`` (``beam_score`` over
chip_smoke.py's seeded 960-wide f32 corpus on the same adjacency: no search
and no snapshot of its own, the f32 frontier stands in), ``int8``
(``beam_score_int8``) and ``pq`` (``beam_score_pq``). Per mode and version:
on 200 sets of random frontier ids (chip_smoke.py's draws) and on the
frontier snapshot, ``ms`` (CUDA events around rounds of 200 back-to-back
calls, median of 5 rounds), ``host_ms`` (host clock per call over the same
rounds, no sync), ``device_ms`` (the kernel's own time, torch.profiler) and
a checksum of the first call's outputs; then the whole 1M search (10k
queries, L = 64, hashed, tiles of 1024) under torch.profiler: the beam
kernel's summed device ms and launches, device busy ms, and recall@10
against brute force (not for ``wide``, nor for variants named ``diag_*``,
which need not compute the function). A third input times the kernel on
the random frontier ids with the L2 cache flushed before each call (a
256 MiB fill), device ms only: the rows as a search finds them after its
other kernels. Last (with ``int8``), the wrapper's host steps one at a time
(``host_steps_us``, us per call over 2000 calls). One JSON line per result,
on stdout and in ``--out`` (appended).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402

B_LANES, K, N_US = 1024, 64, 200


def time_calls(fn, inner: int, rounds: int = 5, warmup: int = 2) -> dict:
    """Per call: CUDA-event ms and host ms (perf_counter, no sync) over
    ``rounds`` rounds of ``inner`` back-to-back calls; medians and spread."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    per, host = [], []
    for r in range(rounds):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        t0 = time.perf_counter()
        for i in range(inner):
            fn(warmup + r * inner + i)
        host.append(1e3 * (time.perf_counter() - t0) / inner)
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / inner)
    return {"ms": statistics.median(per), "ms_spread": [min(per), max(per)],
            "host_ms": statistics.median(host), "host_ms_spread": [min(host), max(host)]}


def make(path: str, modes) -> None:
    from repro_torch.core import rnn_descent as rd
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.quant import Quantization, encode_corpus
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    x, q = clustered_vectors(VectorDatasetSpec.sift_like(C.FULL_N, C.FULL_Q), gen, "cuda")
    data = {"q": q[:B_LANES].contiguous()}
    for mode in sorted({"f32" if m in ("f32", "bf16", "wide") else m for m in modes}):
        quant = Quantization(**C.QUANT_KW[mode]) if mode != "f32" else Quantization()
        cfg = rd.RNNDescentConfig(s=20, r=96, t1=4, t2=15, capacity=128, chunk=512,
                                  quant=quant)
        g = rd.build(x, cfg, torch.Generator(device="cuda").manual_seed(C.SEED + 1))
        if mode == "f32":
            data[mode] = {"neighbors": g.neighbors, "snap": C.frontier_snapshot(x, q, g, mode)}
            continue
        qx = encode_corpus(x, quant)
        data[mode] = {"neighbors": g.neighbors, "codes": qx.codes, "scale": qx.scale,
                      "zero": qx.zero, "codebooks": qx.codebooks,
                      "snap": C.frontier_snapshot(x, q, g, mode, qx)}
    torch.save(data, path)


def host_steps(ops, codes, nbrs, u, q, scale, zero) -> dict:
    """us per call of each host step of a wrapper call, 2000 calls each."""
    dev = codes.device
    ts = (codes, scale, zero, nbrs, u, q)

    def per(fn, calls=2000):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return 1e6 * (time.perf_counter() - t0) / calls

    steps = {
        "checks": lambda: (ops._check_rows(codes, nbrs, u, (torch.int8,), scale, zero, q),
                           ops._check_f32("scale", scale, (codes.shape[1],)),
                           ops._check_f32("zero", zero, (codes.shape[1],)),
                           ops._check_f32("queries", q, (u.shape[0], codes.shape[1]))),
        "three_empty": lambda: [torch.empty((B_LANES, K), dtype=dt, device=dev)
                                for dt in (torch.int32, torch.float32, torch.int32)],
        "one_empty_unbind": lambda: (lambda ids, d, keys: (ids, d.view(torch.float32), keys))(
            *torch.empty((3, B_LANES, K), dtype=torch.int32, device=dev).unbind(0)),
        "six_contiguous": lambda: [t.contiguous() for t in ts],
        "six_is_contiguous": lambda: [t.is_contiguous() for t in ts],
        "nine_data_ptr": lambda: [t.data_ptr() for t in ts + ts[:3]],
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "launch_count": lambda: ops.LAUNCHES.__setitem__(
            "beam_score_int8", ops.LAUNCHES["beam_score_int8"] + 1),
    }
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        steps["raw_stream"] = lambda: torch._C._cuda_getCurrentRawStream(dev.index)
    steps["whole_call"] = lambda: ops.beam_score_int8(codes, scale, zero, nbrs, u, q, K, "l2")
    out = {name: per(fn) for name, fn in steps.items()}
    torch.cuda.synchronize()
    return out


ENTRIES = {"beam_score": "ppppiiiiiiipppp", "beam_score_int8": "ppppppiiiiiipppp",
           "beam_score_pq": "ppppppiiiiiipppp"}
MODES = ("f32", "bf16", "wide", "int8", "pq")


def compile_variants(variants: dict) -> dict:
    """One nvcc per variant source, all at once -> {label: {entry: ctypes
    fn}} for the ENTRIES each source defines."""
    import ctypes
    import subprocess

    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "beam_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, src in variants.items():
        so = os.path.join(out_dir, f"{label}.so")
        procs[label] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:     # a variant that does not build is left out
            print(f"[nvcc {label}] failed:\n{log}", file=sys.stderr)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {label}] {line.strip()}", file=sys.stderr)
        lib = ctypes.CDLL(so)
        libs[label] = {}
        for name, types in ENTRIES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int}[c] for c in types]
                fn.restype = ctypes.c_int
                libs[label][name] = fn
    return libs


def search_beam(x, q, g, qx, mode: str, gt) -> dict:
    """The 1M search of corpus ``mode`` under torch.profiler: the beam
    kernel's summed device ms and launches, device busy ms, recall@10."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import eval as E
    from repro_torch.core import search as S
    from repro_torch.quant import Quantization
    kw = ({"quant": Quantization(**C.QUANT_KW[mode])} if mode in C.QUANT_KW
          else {"gram_dtype": mode})
    cfg = S.SearchConfig(l=64, k=64, max_iters=256, topk=10, **kw)
    ep = S.default_entry_point(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ids, _ = S.search_tiled(x, g, q, ep, cfg, tile_b=1024, qx=qx)
        torch.cuda.synchronize()
    spans, beam = [], [0.0, 0]
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            if "beam_score" in ev.name:
                beam[0] += (ev.time_range.end - ev.time_range.start) / 1e3
                beam[1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    return {"search_beam_ms": beam[0], "search_beam_launches": beam[1],
            "search_busy_ms": busy, "recall_at_10": E.recall_topk(ids, gt)}


def mode_inputs(mode: str, data: dict, x, qb):
    """(entry, fn, us, snap, g, qx) of one mode: the wrapper name, ``fn(u)``
    the l2 call on frontier ``u``, chip_smoke.py's 200 random frontier draws,
    the search's frontier snapshot, and the graph and codes of its 1M search
    (g None: no search)."""
    from repro_torch.core.graph import Graph
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.quant import QuantizedCorpus, pq_lut
    dm = data["f32" if mode in ("bf16", "wide") else mode]
    nbrs = dm["neighbors"]
    n, d = nbrs.shape[0], qb.shape[1]
    g = Graph(nbrs, torch.zeros(nbrs.shape, device="cuda"),
              torch.zeros(nbrs.shape, dtype=torch.uint8, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(
        C.SEED + {"int8": 3, "pq": 4}.get(mode, 2))
    # chip_smoke.py's draws before its random frontiers
    if mode == "int8":     # the integer space's scale and zero
        torch.randint(1, 4, (d,), generator=gen, device="cuda")
        torch.randint(-3, 4, (d,), generator=gen, device="cuda")
    elif mode != "pq":     # the integer-valued corpus
        torch.randint(-8, 9, (n, d), generator=gen, device="cuda")
    us = [torch.randint(0, n, (B_LANES,), generator=gen, device="cuda", dtype=torch.int32)
          for _ in range(N_US)]
    qx = None
    if mode == "int8":
        qx = QuantizedCorpus(dm["codes"], dm["scale"], dm["zero"])

        def fn(u):
            return B.beam_score_int8(qx.codes, qx.scale, qx.zero, nbrs, u, qb, K, "l2")
    elif mode == "pq":
        qx = QuantizedCorpus(dm["codes"], codebooks=dm["codebooks"])
        lut = pq_lut(qb, dm["codebooks"], "l2")

        def fn(u):
            return B.beam_score_pq(qx.codes, nbrs, u, *lut, K, "l2")
    else:
        if mode == "wide":
            rows, qrows = C.wide_rows(n, B_LANES)
            g = None
        else:
            rows, qrows = x.to(torch.bfloat16 if mode == "bf16" else torch.float32), qb

        def fn(u):
            return B.beam_score(rows, nbrs, u, qrows, K, "l2")
    entry = "beam_score" if mode in ("f32", "bf16", "wide") else f"beam_score_{mode}"
    return entry, fn, us, dm["snap"], g, qx


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(ROOT, "build", "beam_ab.pt"))
    ap.add_argument("--make", action="store_true")
    ap.add_argument("--label", default=os.path.basename(ROOT))
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=FILE.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "beam_ab.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("beam_ab: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sink = open(args.out, "a")

    def emit(obj):
        line = json.dumps({"label": args.label, **obj})
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    from repro_torch.core import eval as E
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels import _build
    from repro_torch.kernels.beam_score import ops as B
    t0 = time.perf_counter()
    built = _build.build_all()["seconds"]
    libs = {"own": {name: _build.load(name, types, source="beam_score_pq" if "pq" in name
                                      else "beam_score") for name, types in ENTRIES.items()}}
    libs.update(compile_variants(dict(v.split("=", 1) for v in args.variant)))
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": C.nvidia_smi(),
          "root": ROOT, "build_s": built, "variants_s": time.perf_counter() - t0})
    if args.make:
        t0 = time.perf_counter()
        make(args.data, args.modes.split(","))
        emit({"made": args.data, "seconds": time.perf_counter() - t0})
    data = torch.load(args.data, map_location="cuda")
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    x, q = clustered_vectors(VectorDatasetSpec.sift_like(C.FULL_N, C.FULL_Q), gen, "cuda")
    _, gt = E.ground_truth(x, q, k=10, tile=1024)
    qb = q[:B_LANES].contiguous()
    order = list(libs) + list(libs)[::-1]
    for mode in args.modes.split(","):
        entry, fn, us, snap, g, qx = mode_inputs(mode, data, x, qb)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")

        def flushed(i, fn=fn, us=us):
            flush.zero_()
            return fn(us[i % N_US])
        for version in order:
            if entry not in libs[version]:
                continue
            _build._LIBS[entry] = libs[version][entry]
            for label, pick in (("random frontier", lambda i: us[i % N_US]),
                                ("search frontier", lambda i: snap)):
                ids, dists, _ = fn(pick(0))
                fin = torch.isfinite(dists)
                check = [int(ids.long().sum()), int(fin.sum()), float(dists[fin].double().sum())]
                t = time_calls(lambda i: fn(pick(i)), N_US)
                emit({"kernel": entry, "mode": mode, "version": version, "input": label, **t,
                      "device_ms": C.device_ms(lambda i: fn(pick(i)), N_US, "beam_score"),
                      "checksum": check})
            emit({"kernel": entry, "mode": mode, "version": version,
                  "input": "random frontier, L2 flushed",
                  "device_ms": C.device_ms(flushed, N_US, "beam_score")})
            if g is not None and not version.startswith("diag_"):
                emit({"kernel": entry, "mode": mode, "version": version, "input": "1M search",
                      **search_beam(x, q, g, qx, mode, gt)})
        _build._LIBS[entry] = libs["own"][entry]
        del fn, us, snap, g, qx, flushed, flush
    if "int8" in args.modes.split(","):
        dm = data["int8"]
        emit({"host_steps_us": host_steps(B, dm["codes"], dm["neighbors"], dm["snap"], qb,
                                          dm["scale"], dm["zero"])})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
