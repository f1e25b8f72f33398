"""Relative NN-Descent (paper Algorithm 6), port of ``repro.core.rnn_descent``.

    G <- RandomGraph(S); all flags "new"
    repeat T1 times:
        repeat T2 times:  UpdateNeighbors(G)       (Alg. 4)
        unless last:      AddReverseEdges(G, R)    (Alg. 5)

Every vertex is updated in parallel per sweep; replacement edges (w -> v)
from the fused RNG prune are buffered and merged (bucketed merge by default,
on the card the ``bucket_merge`` CUDA kernels; the sort oracle on request).
The fused prune is the ``rng_prune`` CUDA kernel on the card and its plain
version on the CPU; under ``quant.mode="int8"`` it is ``rng_prune_int8``,
which gathers code rows and decodes them in registers.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import as_tensor
from repro_torch.core import graph as G
from repro_torch.kernels.bucket_merge import ops as merge_ops
from repro_torch.kernels.rng_prune import ops as rng_ops
from repro_torch.quant import Quantization, QuantizedCorpus, corpus_bytes, prep_corpus

GRAM_DTYPES = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class RNNDescentConfig:
    """Paper defaults: S=20, R=96, T1=4, T2=15 (§5.1)."""

    s: int = 20            # out-degree of the random initial graph
    r: int = 96            # reverse-edge degree cap
    t1: int = 4            # outer iterations (reverse-edge phases: t1 - 1)
    t2: int = 15           # UpdateNeighbors sweeps per outer iteration
    capacity: int = 128    # static adjacency capacity M (>= r)
    metric: str = "l2"
    chunk: int = 512       # rows per gathered block of the plain prune
    gram_dtype: str = "f32"    # "bf16": the prune gathers bf16 rows, f32 Gram
    merge: str = "bucketed"    # "bucketed" (scatter buckets) | "sort" (oracle)
    n_buckets: int | None = None   # bucket width override (power of two)
    quant: Quantization = Quantization()  # corpus representation at build time

    def __post_init__(self):
        if self.capacity < self.r:
            raise ValueError(
                f"capacity={self.capacity} must hold the R={self.r} reverse "
                "edges added by AddReverseEdges (capacity >= r)")
        if self.merge not in G.MERGE_MODES:
            raise ValueError(
                f"unknown merge mode {self.merge!r}: expected one of "
                f"{G.MERGE_MODES}")
        if self.gram_dtype not in GRAM_DTYPES:
            raise ValueError(
                f"unknown gram_dtype {self.gram_dtype!r}: expected one of "
                f"{GRAM_DTYPES}")
        if not isinstance(self.quant, Quantization):
            raise ValueError(
                f"quant must be a repro_torch.quant.Quantization, got "
                f"{type(self.quant).__name__}")
        if self.quant.is_coded and self.gram_dtype == "bf16":
            raise ValueError(
                f"quant.mode={self.quant.mode!r} conflicts with "
                "gram_dtype=\"bf16\": pick one compression (use "
                "quant.mode=\"bf16\" for half-width gathers)")

    @property
    def effective_gram_dtype(self) -> str:
        """``quant.mode="bf16"`` selects the bf16-gather path."""
        return "bf16" if self.quant.mode == "bf16" else self.gram_dtype


def random_init(x: torch.Tensor, cfg: RNNDescentConfig,
                generator: torch.Generator | None = None) -> G.Graph:
    """RandomGraph(S)."""
    return G.random_init_graph(x, cfg.s, cfg.capacity, cfg.metric, generator)


def gram_input(x: torch.Tensor, cfg: RNNDescentConfig) -> torch.Tensor:
    """The corpus as the prune gathers it (bf16 under the effective gram
    dtype "bf16")."""
    return x.to(torch.bfloat16) if cfg.effective_gram_dtype == "bf16" else x


def prune_rows(x: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
               flags: torch.Tensor, cfg: RNNDescentConfig,
               qx: QuantizedCorpus | None = None):
    """Fused prune over a block of adjacency rows -> (keep bool, red_w,
    red_d). ``qx`` (int8 codes) prunes over the code rows instead of ``x``."""
    if qx is not None:
        keep, red_w, red_d = rng_ops.rng_prune_int8(qx.codes, qx.scale, qx.zero, ids, dists,
                                                    flags, metric=cfg.metric, chunk=cfg.chunk)
    else:
        keep, red_w, red_d = rng_ops.rng_prune(x, ids, dists, flags,
                                               metric=cfg.metric, chunk=cfg.chunk)
    return keep.bool(), red_w, red_d


def merge_pruned(g: G.Graph, keep, red_w, red_d, cfg: RNNDescentConfig):
    """Merge one sweep's prune output into rows of ``g``'s width -> (Graph,
    the number of real candidates): the bucketed merge through the
    ``bucket_merge`` wrapper (the kernels on the card, the plain version on
    the CPU), the sort oracle through the plain version."""
    ids, dists = g.neighbors, g.dists
    if cfg.merge == "bucketed":
        b = cfg.n_buckets or G.default_buckets(ids.shape[1])
        return merge_ops.bucket_merge(ids, dists, keep, red_w, red_d, b)
    return merge_ops.bucket_merge_ref(ids, dists, keep, red_w, red_d, None, merge=cfg.merge)


def update_neighbors(x: torch.Tensor, g: G.Graph, cfg: RNNDescentConfig,
                     qx: QuantizedCorpus | None = None) -> G.Graph:
    """Paper Algorithm 4, one parallel sweep over all vertices: keep the RNG
    survivors (flags become "old"), and merge each dropped v's replacement
    edge (w -> v) into w's row, flagged "new". ``x`` is cast to the gram
    dtype if it is not in it already; ``qx`` (int8) prunes over codes.

    Observability: the prune runs under an ``rng_prune/rows`` span (rows,
    capacity m, d, the gathered itemsize, and the valid candidates going
    in: ``cands_valid`` = sum of v, ``cands_valid_sq`` = sum of v^2), the
    merge (:func:`merge_pruned`: on the card the two ``bucket_merge``
    kernels) under ``graph/merge`` (the ``rows`` rewritten and their width
    ``m``, the ``rows_changed`` that hold a NEW edge after it, the
    ``cands_scattered`` real candidates it merged); each with its launches
    and, on the card, ``device_ms``. The counts are launched after both
    spans and read with their times after the enclosing costed block's
    wait."""
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    dev = g.neighbors.device
    n, m = g.neighbors.shape
    xg = gram_input(x, cfg)
    with _tr.span("rng_prune/rows") as psp, _ch.span_costs(psp, dev) as pc:
        keep, red_w, red_d = prune_rows(xg, g.neighbors, g.dists, g.flags, cfg, qx=qx)
    with _tr.span("graph/merge") as msp, _ch.span_costs(msp, dev) as mc:
        out, scattered = merge_pruned(g, keep, red_w, red_d, cfg)
    if psp:
        gathered = xg if qx is None else qx.codes
        psp.set(rows=n, m=m, d=gathered.shape[1], itemsize=gathered.element_size())
        pc.defer(**_gs.prune_counts(g))
    if msp:
        msp.set(rows=n, m=m)                  # the merge rewrites every row
        mc.defer(cands_scattered=scattered, **_gs.merge_counts(out))
    return out


def add_reverse_edges(g: G.Graph, cfg: RNNDescentConfig) -> G.Graph:
    """Paper Algorithm 5."""
    return G.add_reverse_edges(g, cfg.r, merge=cfg.merge, n_buckets=cfg.n_buckets)


def build(x, cfg: RNNDescentConfig, generator: torch.Generator | None = None,
          device: str | torch.device = "cuda", mesh=None) -> G.Graph:
    """Paper Algorithm 6. ``x`` (n, d) float32: a tensor runs on its own
    device; numpy input is placed on ``device``. ``generator`` (on x's
    device) draws the random initial graph; None seeds one with 0.

    ``cfg.quant`` int8/pq builds the graph over the decoded corpus
    (:func:`prep_corpus`), the geometry the coded search traverses; the int8
    prune gathers code rows instead of f32 rows.

    ``mesh`` (``launch.mesh.Mesh``): every rank of the mesh calls this with
    the same corpus and generator state, and the sweeps run row-sharded
    (``core/shard.py``); every rank gets the whole graph, equal bit for bit
    to ``mesh=None``'s.

    Observability: with ``repro_torch.obs`` enabled each sweep runs under
    an ``rnn_descent/sweep`` span (each reverse pass under
    ``rnn_descent/reverse``) that synchronises the card once at its end
    and records the sweep's edge readouts, kernel launches and device
    time; a coded build's encode (:func:`prep_corpus`) runs under a
    ``quant/encode`` span (rows, d, mode, the bytes of the int8 codes the
    prune gathers, and on the card ``device_ms``). The launches are the same either way, so the built
    graph is bit for bit the untraced one."""
    from repro_torch.obs import cudahooks as _ch
    from repro_torch.obs import graphstats as _gs
    from repro_torch.obs import trace as _tr
    x = as_tensor(x, device, torch.float32)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    qx = None
    if cfg.quant.is_coded:
        with _tr.span("quant/encode") as sp, _ch.span_costs(sp, x.device):
            x, qx = prep_corpus(x, cfg.quant)
        if sp:
            n, d = x.shape
            sp.set(rows=n, d=d, mode=cfg.quant.mode)
            if qx is not None:      # int8: the codes the prune gathers
                sp.set(code_bytes=corpus_bytes(qx, n, d)["codes_bytes"])
    if mesh is not None:
        from repro_torch.core import shard
        return shard.build_rnn_descent(x, cfg, generator, mesh, qx=qx)
    g = random_init(x, cfg, generator)
    xg = gram_input(x, cfg)              # cast once per build, not per sweep
    prev_live, sweep = None, 0
    for t1 in range(cfg.t1):
        for _ in range(cfg.t2):
            with _tr.span("rnn_descent/sweep") as sp, _ch.span_costs(sp, x.device):
                g = update_neighbors(xg, g, cfg, qx=qx)
                if sp:
                    _gs.sync(g.neighbors)
                    prev_live = _gs.record_sweep(
                        sp, g, algo="rnn_descent", phase="sweep",
                        prev_live=prev_live, sweep=sweep, t1=t1)
            sweep += 1
        if t1 != cfg.t1 - 1:
            with _tr.span("rnn_descent/reverse") as sp, _ch.span_costs(sp, x.device):
                g = add_reverse_edges(g, cfg)
                if sp:
                    _gs.sync(g.neighbors)
                    prev_live = _gs.record_sweep(
                        sp, g, algo="rnn_descent", phase="reverse", t1=t1)
    return g


def build_jit(x, cfg: RNNDescentConfig, generator: torch.Generator | None = None) -> G.Graph:
    """The reference's name for the whole build as one compiled program
    (``lax.scan`` over the sweeps), which ``launch.steps.bind`` binds. The
    port has no jit: this is :func:`build`, the same graph."""
    return build(x, cfg, generator)
