"""Collective-traffic budget checks for the sharded build and the
corpus-sharded search (the port of ``repro.analysis.collectives``).

The reference compiles the sharded programs and walks their HLO for
collective bytes; the port's collectives are explicit calls of
``distributed/comm.py``, which counts the payload bytes each rank puts on
the wire (``mesh.stats.sent_bytes``, per collective). This pass runs the
programs on D = 2 gloo CPU ranks and checks those counts.

Construction budget — the destination-bucketed exchange
(``core/shard.py`` ``exchange_scatter``) ships each peer exactly its own
(n_pad/D, B) block over a ring of D - 1 ``ppermute`` hops, so the wire
bytes a rank sends are known in closed form (``shard._exchange_attrs``):
9 bytes a slot (key, id, flag) for each of the t1 * t2 candidate merges,
22 for each of the t1 - 1 reverse passes' two exchanges. The ring's bytes
must stay within ``DEFAULT_FACTOR`` (the reference's 1.5) of it; anything
re-replicating bulk state — full-height tables, a corpus re-broadcast —
trips it.

Serving budget — corpus-sharded search (``core/search_sharded.py``) moves
frontier ids, adjacency rows of the frontier and per-candidate keys:
O(lanes x iterations x k) bytes. The corpus stays home, so the bytes a rank
sends over one search where the corpus dwarfs the beam traffic stay under
one corpus broadcast (n x d x 4).

It spawns ranks, so it runs only when named (``--passes collectives``).
"""
from __future__ import annotations

import os

from repro_torch.analysis.baseline import Finding

DEFAULT_FACTOR = 1.5
BUILD_N, BUILD_D = 64, 8
SERVE_N, SERVE_D, SERVE_B = 4096, 32, 8


def _build_cfg():
    from repro_torch.core import rnn_descent as rd
    return rd.RNNDescentConfig(s=4, r=8, t1=2, t2=2, capacity=16, chunk=32)


def budget_bytes(n: int, world: int, cfg, factor: float = DEFAULT_FACTOR) -> int:
    """``factor`` x the closed-form ring bytes one rank sends over a
    sharded RNN-Descent build of n rows on ``world`` ranks."""
    from types import SimpleNamespace

    from repro_torch.core import graph as G
    from repro_torch.core import shard
    mesh = SimpleNamespace(axis_names=("data",), shape={"data": world})

    def wire(b, slot):
        return shard._exchange_attrs(n, mesh, b, slot)["exchange_bytes_per_device"]

    closed = (cfg.t1 * cfg.t2 * wire(cfg.n_buckets or G.default_buckets(cfg.capacity), 9)
              + (cfg.t1 - 1) * wire(cfg.n_buckets or G.default_buckets(cfg.r), 22))
    return int(factor * closed)


def measure(mesh, device: str = "cpu", seed: int = 0) -> dict:
    """Rank side: a sharded build of BUILD_N x BUILD_D rows and one
    corpus-sharded search over SERVE_N x SERVE_D rows, each with the mesh's
    counters zeroed before it; returns the bytes this rank sent in each."""
    import torch

    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S

    def draw(i, shape):
        g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
        return torch.randn(shape, generator=g, device=device)

    cfg = _build_cfg()
    mesh.stats.reset()
    rd.build(draw(0, (BUILD_N, BUILD_D)), cfg, torch.Generator(device=device).manual_seed(1),
             mesh=mesh)
    build = mesh.stats.summary()
    x = draw(1, (SERVE_N, SERVE_D))
    g = rd.build(x, cfg, torch.Generator(device=device).manual_seed(2))
    mesh.stats.reset()
    S.search_tiled(x, g, draw(2, (SERVE_B, SERVE_D)), 0,
                   S.SearchConfig(l=8, k=8, max_iters=8, topk=4), tile_b=SERVE_B,
                   mesh=mesh, shard="corpus")
    serve = mesh.stats.summary()
    return {"build_ring_bytes": build.get("ppermute", {}).get("sent_bytes", 0),
            "build_bytes_by_op": {k: v["sent_bytes"] for k, v in build.items()},
            "serve_bytes": sum(v["sent_bytes"] for v in serve.values()),
            "serve_bytes_by_op": {k: v["sent_bytes"] for k, v in serve.items()}}


def findings_of(ranks: list[dict], world: int, factor: float = DEFAULT_FACTOR,
                log=print) -> list[Finding]:
    budget = budget_bytes(BUILD_N, world, _build_cfg(), factor)
    corpus = SERVE_N * SERVE_D * 4
    findings = []
    for r, res in enumerate(ranks):
        got = res["build_ring_bytes"]
        log(f"collectives: rank {r}/{world}: build ring bytes={got} (budget {budget}) "
            f"by op: {res['build_bytes_by_op']}; corpus-sharded search bytes="
            f"{res['serve_bytes']} (corpus stays home: < {corpus}) by op: "
            f"{res['serve_bytes_by_op']}")
        if got > budget:
            findings.append(Finding(
                "collectives", "wire-bytes-budget", f"shard.build_rnn_descent@rank{r}",
                f"{got} ring bytes sent exceed the budget {budget} ({factor}x the "
                f"per-peer-block exchange formula); by op: {res['build_bytes_by_op']}"))
        if res["serve_bytes"] >= corpus:
            findings.append(Finding(
                "collectives", "corpus-stays-home", f"search.search_tiled@corpus@rank{r}",
                f"{res['serve_bytes']} bytes sent in one corpus-sharded search reach one "
                f"corpus broadcast ({corpus}); by op: {res['serve_bytes_by_op']}"))
    return findings


def _rank(rank: int, world: int, out_dir: str) -> None:
    import torch

    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    mesh = M.make_mesh((world,), ("data",), backend="gloo", device="cpu")
    torch.save(measure(mesh), os.path.join(out_dir, f"rank{rank}.pt"))


def run(factor: float = DEFAULT_FACTOR, log=print, world: int = 2) -> list[Finding]:
    """Spawn ``world`` gloo CPU ranks and check their counts."""
    import tempfile

    import torch

    from repro_torch.launch import mesh as M
    with tempfile.TemporaryDirectory() as out:
        M.spawn(_rank, world, (out,), backend="gloo", timeout_s=120)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    return findings_of(ranks, world, factor, log)
