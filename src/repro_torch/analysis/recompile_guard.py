"""Rebuild guard: the port's form of the reference's recompilation guard
(``repro.analysis.recompile_guard``), over its scripted streaming churn at
its sizes.

The port compiles nothing at run time except the hand kernels, and those
once per source (``kernels/_build.build_all``: nvcc into a library, loaded
with ctypes); nothing runs under ``torch.compile``. So the failure modes
the reference guards against become:

* a kernel build or library load after warm-up — a source hash that
  changes from call to call, a library opened per call — which would put
  seconds of nvcc or a dlopen into a serving path: steady-state churn
  (same-shape insert, delete and search at a fixed capacity) and growth
  must build no kernel and open no library (the ``obs.cudahooks``
  tallies' delta is 0);
* a capacity schedule off ``store.next_capacity``'s powers of two: the
  store must grow by exact doublings, one new capacity a doubling, so a
  store growing from n0 to n sees O(log n / n0) capacities.

It runs real work on ``device`` (the card when one is present).
"""
from __future__ import annotations

from repro_torch.analysis.baseline import Finding


class build_counter:
    """Context manager counting kernel builds and library loads inside the
    block (``count`` after exit; ``so_far`` inside)."""

    def __enter__(self) -> "build_counter":
        from repro_torch.obs import cudahooks
        self._hooks = cudahooks
        self._start = self._now()
        return self

    def _now(self) -> int:
        return self._hooks.kernel_builds() + self._hooks.kernel_libs_loaded()

    def __exit__(self, *exc) -> None:
        self.count = self._now() - self._start

    @property
    def so_far(self) -> int:
        return self._now() - self._start


def churn_workload(batch: int = 16, steady_rounds: int = 4, n_growths: int = 3,
                   seed: int = 0, device: str = "cuda"):
    """Run the scripted churn; returns (steady_builds, growth_builds,
    capacities)."""
    import torch

    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.streaming import StreamingANN, StreamingConfig
    from repro_torch.streaming import store as ST

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("recompile guard: no CUDA device (pass device=\"cpu\")")
    cfg = StreamingConfig(
        build=rd.RNNDescentConfig(s=4, r=8, t1=2, t2=2, capacity=16, chunk=64),
        seed_l=16, seed_k=8, seed_iters=16, search_k=8, batch_k=4,
        sweeps=1, splice_k=4, delete_fanout=8)
    scfg = S.SearchConfig(l=8, k=8, max_iters=16, topk=4)
    d = 8

    def draw(i: int, rows: int):
        g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + i)
        return torch.randn((rows, d), generator=g, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x0, queries = draw(0, 48), draw(1, 8)
    ann = StreamingANN.from_corpus(x0, cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                                   device=dev)
    # pre-grow so warm-up + steady fit one capacity: deletes only tombstone
    # (rows stay occupied until compact), so every insert consumes fresh
    # rows
    ann.store = ST.grow(ann.store,
                        ST.occupied_count(ann.store) + (2 + steady_rounds + 1) * batch)

    # warm-up: one full round loads every kernel the steady phase uses
    ids = ann.insert(draw(2, batch))
    ann.delete(ids)
    ids = ann.insert(draw(3, batch))
    ann.delete(ids[: batch // 2])
    ann.delete(ids[batch // 2:])
    ann.search(queries, scfg)
    sync()

    with build_counter() as steady:
        for i in range(steady_rounds):
            ids = ann.insert(draw(4 + i, batch))
            ann.search(queries, scfg)
            ann.delete(ids)
        sync()

    capacities = [ann.capacity]
    with build_counter() as growth:
        i = 100
        while len(capacities) <= n_growths:
            ann.insert(draw(i, batch))
            i += 1
            if ann.capacity != capacities[-1]:
                capacities.append(ann.capacity)
        sync()
    return steady.count, growth.count, capacities


def run(log=print, batch: int = 16, steady_rounds: int = 4, n_growths: int = 3,
        device: str | None = None) -> list[Finding]:
    """``device`` None: the card when one is present, else the CPU (where no
    kernel exists and the build counts are trivially 0; the growth
    schedule is checked all the same)."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    steady, growth, caps = churn_workload(batch=batch, steady_rounds=steady_rounds,
                                          n_growths=n_growths, device=device)
    log(f"recompile-guard ({device}): steady-state kernel builds + library loads={steady} "
        f"(budget 0), during growth={growth} (budget 0) over capacities {caps}")
    findings = []
    if steady > 0:
        findings.append(Finding(
            "recompile", "steady-state-rebuild", "streaming-churn",
            f"{steady} kernel builds or library loads during fixed-shape churn "
            f"({steady_rounds} insert/search/delete rounds at capacity {caps[0]})"))
    if growth > 0:
        findings.append(Finding(
            "recompile", "growth-rebuild", "streaming-churn",
            f"{growth} kernel builds or library loads across {len(caps) - 1} capacity "
            "doublings: a kernel must not depend on the store's capacity"))
    for a, b in zip(caps, caps[1:]):
        if b != 2 * a:
            findings.append(Finding(
                "recompile", "growth-schedule", "streaming-churn",
                f"capacity stepped {a} -> {b}, expected exact doubling "
                "(store.next_capacity power-of-two contract)"))
    return findings
