"""The row-sharded RNN-Descent build (paper build FULL) of the first ``--n``
rows of ``chip_smoke.py``'s 1M corpus on ``--ranks`` gloo ranks sharing one
card, held bit for bit to the single-device build from the same generator
seed; the sharded phase of ``chip_smoke.py`` runs it over 500k rows to fit
its time, this runs it at any size.

    python3 scripts/sharded_build.py [--n 1000000] [--ranks 2 [4 ...]]

Prints the card's name and power limit, then one JSON line for each group
size: the single device's build seconds, and for each rank the build
seconds, the ring's seconds (CUDA events around its hops, the wait for the
peer included), its sent and staged bytes against the closed form, the
peak memory and the launches. Exits non-zero if a rank's graph differs.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (its helpers; it puts src/ on the path)
import torch  # noqa: E402


def rank_main(rank, world, x, g_ref, out_dir):
    from repro_torch.core import rnn_descent as rd
    mesh = cs._card_mesh(world, "gloo")
    g, st = cs._timed_build(mesh, lambda: rd.build(
        x, cs.full_build(),
        torch.Generator(device="cuda").manual_seed(cs.SEED + 1), mesh=mesh))
    st["equal"] = all(torch.equal(a, b) for a, b in zip(g, g_ref))
    cs._rank_out(out_dir, rank, st)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=cs.FULL_N)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_build: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import graph as G
    from repro_torch.core import rnn_descent as rd
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels import _build
    smi = cs.nvidia_smi()
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x, _ = clustered_vectors(VectorDatasetSpec.sift_like(cs.FULL_N, cs.FULL_Q), gen, "cuda")
    x = x[:args.n].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = rd.build(x, cs.full_build(),
                 torch.Generator(device="cuda").manual_seed(cs.SEED + 1))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    print(smi, flush=True)
    full = cs.full_build()
    b, br = G.default_buckets(full.capacity), G.default_buckets(full.r)
    ok = True
    for d in args.ranks:
        ranks = cs.spawn_ranks(rank_main, d, "gloo", x, g)
        n_pad = -(-args.n // d) * d
        hop = n_pad // d * (d - 1)
        closed = full.t1 * full.t2 * 9 * b * hop \
            + (full.t1 - 1) * 22 * br * hop
        print(json.dumps({"n": args.n, "ranks": d, "backend": "gloo",
                          "build": "FULL s=20 r=96 t1=4 t2=15 M=128",
                          "single_device_build_s": single_s, "wire_bytes_closed_form": closed,
                          "per_rank": ranks}), flush=True)
        ok &= all(r["equal"] and r["sent_bytes"] == closed for r in ranks)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
