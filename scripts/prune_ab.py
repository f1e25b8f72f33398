"""A/B timing of two versions of the prune kernels' source on one card.

    python3 scripts/prune_ab.py A.cu B.cu [--out build/prune_ab.jsonl]

A and B are copies of ``src/repro_torch/kernels/csrc/rng_prune.cu`` with the
same C entry points (``rng_prune``, ``rng_prune_int8``). Each is compiled
with the package's nvcc flags; the wrappers in ``kernels/rng_prune/ops.py``
are then routed through one or the other. On the main path's 1M corpus
(chip_smoke.py's seed and FULL build configuration) the script:

  1. runs the f32 build four times, in the order A, B, B, A, then the int8
     build (which prunes over the codes) likewise, and reports each build's
     seconds and its prune seconds (CUDA events around every ``prune_rows``
     call); a mode's four graphs must be equal, since every row's outputs
     depend only on that row;
  2. keeps the first f32 build's prune inputs at sweeps 1 and 16 and its final
     graph, and times both versions on each, all 1M rows and the first 8192
     rows, over the f32 corpus and over its int8 codes: CUDA events around
     rounds of back-to-back calls (median round and spread), interleaved A,
     B, B, A; the two versions' outputs must be equal.

Each result is one JSON line on stdout and in ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ARGTYPES = {"rng_prune": "ppppiiiiiippppp", "rng_prune_int8": "ppppppiiiiippppp"}


def compile_all(sources: dict) -> dict:
    """One nvcc per source, all at once -> ({label: {entry: ctypes fn}},
    {label: ptxas register lines})."""
    out_dir = os.path.join(ROOT, "build", "prune_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        so = os.path.join(out_dir, f"{label}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), so)
    libs, regs = {}, {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        regs[label] = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        lib = ctypes.CDLL(so)
        libs[label] = {}
        for name, types in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int}[c] for c in types]
            fn.restype = ctypes.c_int
            libs[label][name] = fn
    return libs, regs


def use(libs: dict, label: str) -> None:
    """Route the prune wrappers through version ``label``."""
    _build._LIBS.update(libs[label])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "prune_ab.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prune_ab: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    sink = open(args.out, "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    from repro_torch.core import rnn_descent as rd
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels.rng_prune import ops as R
    from repro_torch.quant import Quantization, encode_corpus

    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": C.nvidia_smi(),
          "a": args.a, "b": args.b})
    t0 = time.perf_counter()
    libs, regs = compile_all({"A": args.a, "B": args.b})
    emit({"compile_s": time.perf_counter() - t0, "ptxas": regs})

    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    x, _ = clustered_vectors(VectorDatasetSpec.sift_like(C.FULL_N, 16), gen, "cuda")
    cfg = rd.RNNDescentConfig(s=20, r=96, t1=4, t2=15, capacity=128, chunk=512)
    for label in ("A", "B"):          # load each module before any timing
        use(libs, label)
        R.rng_prune(x, *(t[:4] for t in rd.random_init(x, cfg, gen)))
    torch.cuda.synchronize()

    # -- 1. whole builds, A B B A, per corpus mode
    snap = {}
    for mode in ("f32", "int8"):
        mcfg = dataclasses.replace(cfg, quant=Quantization(mode=mode)) if mode != "f32" else cfg
        graphs = {}
        for k, label in enumerate("ABBA"):
            use(libs, label)
            orig, sweep = rd.update_neighbors, [0]
            first = mode == "f32" and k == 0

            def wrapper(xx, g, *a, _orig=orig, _first=first, **kw):
                sweep[0] += 1
                if _first and sweep[0] in C.SNAP_SWEEPS:
                    snap[f"sweep {sweep[0]}"] = tuple(t.clone() for t in g)
                return _orig(xx, g, *a, **kw)
            rd.update_neighbors = wrapper
            try:
                with C.event_timed(rd, ("prune_rows",)) as ev:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    g = rd.build(x, mcfg,
                                 torch.Generator(device="cuda").manual_seed(C.SEED + 1))
                    torch.cuda.synchronize()
                    build_s = time.perf_counter() - t1
            finally:
                rd.update_neighbors = orig
            emit({"build": k, "mode": mode, "version": label, "build_s": build_s,
                  "prune_s": sum(ev["prune_rows"]) / 1e3, "sweeps": len(ev["prune_rows"])})
            if label in graphs:
                C.check(all(torch.equal(a, b) for a, b in zip(g, graphs[label])),
                        f"{mode} version {label}: two builds differ")
            else:
                graphs[label] = g
            if first:
                snap["final graph"] = tuple(t.clone() for t in g)
        C.check(all(torch.equal(a, b) for a, b in zip(graphs["A"], graphs["B"])),
                f"{mode}: the versions' graphs differ")
        del graphs, g

    # -- 2. per call, on captured inputs
    qx = encode_corpus(x, Quantization(mode="int8"))
    calls = {
        "f32": lambda ids, dists, flags: R.rng_prune(x, ids, dists, flags, "l2"),
        "int8": lambda ids, dists, flags: R.rng_prune_int8(qx.codes, qx.scale, qx.zero,
                                                            ids, dists, flags, "l2"),
    }
    for label_in, full in snap.items():
        for rows in (C.FULL_N, C.PRUNE_ROWS):
            ids, dists, flags = (t[:rows].contiguous() for t in full)
            e = C.row_extent(ids >= 0).double()
            for corpus, fn in calls.items():
                outs, times = {}, {"A": [], "B": []}
                for label in "ABBA":
                    use(libs, label)
                    outs.setdefault(label, fn(ids, dists, flags))
                    t = C.time_ms(lambda i: fn(ids, dists, flags),
                                  inner=5 if rows == C.FULL_N else 20)
                    times[label].append(t)
                C.check(all(torch.equal(a, b) for a, b in zip(outs["A"], outs["B"])),
                        f"{label_in} {rows} {corpus}: the versions' outputs differ")
                emit({"input": label_in, "rows": rows, "corpus": corpus,
                      "e_mean": float(e.mean()), "e_max": int(e.max()),
                      **{f"{v}_ms": [t["ms"] for t in times[v]] for v in "AB"},
                      **{f"{v}_spread": [[t["ms_min"], t["ms_max"], t["calls"]]
                                         for t in times[v]] for v in "AB"}})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
