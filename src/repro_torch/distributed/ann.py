"""Mesh-aware ANN index: sharded build, sharded serving, elastic persistence
(port of ``repro.distributed.ann``).

One object owns the corpus, the built graph and the mesh, and routes every
operation through the sharded paths when a mesh is present (build ->
``core/shard.py``; search -> ``search_tiled(shard="queries")``, or the
corpus-sharded beam of ``core/search_sharded.py`` when
``serve_shard="corpus"``) or the single-device paths when it is not, with
identical results either way. Under a mesh every rank holds one
``ShardedANN`` and calls each method with the same arguments.

Placement is plain tensors on the rank's device: ``serve_shard="queries"``
keeps the whole corpus, graph and codes on every rank
(:func:`place_replicated`); ``"corpus"`` keeps the rank's block of the
rows, padded to a multiple of the shard count (:func:`place_rows`), and
``n`` and the default entry points (taken on the whole corpus) beside it.

Persistence goes through the port's checkpoint (the reference's on-disk
format): the whole graph (gathered from the ranks' blocks under corpus
placement) and the codes, written once, by the mesh's rank 0. A checkpoint
restores onto a mesh of any size, or none, and serves the same results;
either package restores the other's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import as_tensor, checkpoint, resolve_device
from repro_torch.core import graph as G
from repro_torch.core import search as S
from repro_torch.quant import QuantizedCorpus, encode_corpus

METHODS = ("rnn-descent", "nn-descent", "nsg-style")
SERVE_SHARDS = ("queries", "corpus")


def _default_cfg(method: str):
    if method == "rnn-descent":
        from repro_torch.core.rnn_descent import RNNDescentConfig
        return RNNDescentConfig()
    if method == "nn-descent":
        from repro_torch.core.nn_descent import NNDescentConfig
        return NNDescentConfig()
    if method == "nsg-style":
        from repro_torch.core.nsg_style import NSGStyleConfig
        return NSGStyleConfig()
    raise ValueError(f"unknown method {method!r}: expected one of {METHODS}")


def _build_fn(method: str):
    if method == "rnn-descent":
        from repro_torch.core import rnn_descent as rd
        return rd.build
    if method == "nn-descent":
        from repro_torch.core import nn_descent as nnd
        return nnd.build
    from repro_torch.core import nsg_style
    return nsg_style.build


def place_rows(tree, mesh, n: int | None = None):
    """This rank's block of every tensor of ``tree`` (a Graph, a
    QuantizedCorpus, a tensor) over the mesh's "rows" axes, padded to a
    multiple of the shard count: adjacency ids with -1, distances with +inf,
    anything else with 0. With ``n`` given, only tensors whose leading dim
    is ``n`` are per-row; the rest (int8 scale/zero, PQ codebooks) stay
    whole. ``mesh=None`` returns ``tree``."""
    from repro_torch.core.search_sharded import local_block
    if mesh is None or tree is None:
        return tree

    def put(t, fill=0):
        if t is None:
            return None
        t = t.to(mesh.device)
        if n is not None and (t.dim() == 0 or t.shape[0] != n):
            return t
        return local_block(t, mesh, fill)

    if isinstance(tree, G.Graph):
        return G.Graph(put(tree.neighbors, -1), put(tree.dists, float("inf")),
                       put(tree.flags, G.OLD))
    if isinstance(tree, QuantizedCorpus):
        return QuantizedCorpus(*(put(t) for t in tree))
    return put(tree)


def place_replicated(tree, mesh):
    """The whole ``tree`` on the rank's device (every rank holds a copy)."""
    if mesh is None or tree is None:
        return tree
    if isinstance(tree, tuple):
        return type(tree)(*(None if t is None else t.to(mesh.device) for t in tree))
    return tree.to(mesh.device)


@dataclasses.dataclass
class ShardedANN:
    """A built index bound to a (possibly absent) mesh.

    >>> ann = ShardedANN.build(x, method="rnn-descent", mesh=mesh)
    >>> ids, dists = ann.search(queries, S.SearchConfig(l=32, topk=10))
    >>> ann.save("/ckpts/idx")                      # mesh-shape-independent
    >>> ann2 = ShardedANN.restore("/ckpts/idx", x, mesh=other_mesh)
    """

    x: torch.Tensor
    graph: G.Graph
    mesh: Any = None
    method: str = "rnn-descent"
    build_cfg: Any = None
    qx: QuantizedCorpus | None = None
    serve_shard: str = "queries"
    n: int | None = None                 # corpus rows (x may be a block)
    entries: dict | None = None          # metric -> default entry point (corpus placement)

    @classmethod
    def build(cls, x, method: str = "rnn-descent", cfg=None,
              generator: torch.Generator | None = None, mesh=None,
              serve_shard: str = "queries", device: str | torch.device = "cuda") -> "ShardedANN":
        """Construct the index, row-sharded over ``mesh`` when given (every
        rank passes the same corpus and generator state). A coded
        ``cfg.quant`` builds in the quantized geometry and keeps the codes
        for serving. ``serve_shard``: "queries" keeps corpus and graph whole
        on every rank and shards query tiles; "corpus" keeps each rank's
        block of the rows (about 1/D of the index) and serves through
        collectives, with the same results."""
        cfg = cfg if cfg is not None else _default_cfg(method)
        x = as_tensor(x, device if mesh is None else mesh.device, torch.float32)
        g = _build_fn(method)(x, cfg, generator, mesh=mesh)
        quant = getattr(cfg, "quant", None)
        qx = None
        if quant is not None and quant.is_coded:
            # the builder's deterministic encode (prep_corpus), repeated for serving
            qx = encode_corpus(x, quant)
        return cls(x=x, graph=g, mesh=mesh, method=method, build_cfg=cfg, qx=qx,
                   serve_shard=serve_shard)._placed()

    def _placed(self) -> "ShardedANN":
        """Place corpus, graph and codes (all whole here) for the serving
        mode."""
        if self.serve_shard not in SERVE_SHARDS:
            raise ValueError(f"serve_shard={self.serve_shard!r}: expected one of "
                             f"{SERVE_SHARDS}")
        n = int(self.x.shape[0])
        if self.mesh is None or self.serve_shard == "queries":
            return dataclasses.replace(
                self, n=n, x=place_replicated(self.x, self.mesh),
                graph=place_replicated(self.graph, self.mesh),
                qx=place_replicated(self.qx, self.mesh))
        entries = {m: S.default_entry_point(self.x, m) for m in S.METRICS}
        return dataclasses.replace(
            self, n=n, entries=entries, x=place_rows(self.x, self.mesh, n),
            graph=place_rows(self.graph, self.mesh, n), qx=place_rows(self.qx, self.mesh, n))

    @property
    def _corpus_sharded(self) -> bool:
        return self.mesh is not None and self.serve_shard == "corpus"

    def device_resident_bytes(self) -> int:
        """Bytes of corpus + graph (+ codes) this rank holds, the maximum
        over the mesh's ranks: about the whole index under
        ``serve_shard="queries"``, about 1/D of it under ``"corpus"``."""
        leaves = [self.x, *self.graph]
        if self.qx is not None:
            leaves += [t for t in self.qx if t is not None]
        total = sum(t.numel() * t.element_size() for t in leaves)
        if self.mesh is None:
            return total
        from repro_torch.distributed import comm as C
        return int(C.pmax(torch.tensor(total, device=self.mesh.device), self.mesh,
                          self.mesh.axis_names))

    def search(self, queries, cfg: S.SearchConfig | None = None, entry_points=None,
               tile_b: int = 256):
        """Serve through the tiled driver: query tiles shard over the mesh,
        or, under ``serve_shard="corpus"``, the corpus-sharded beam, so the
        corpus never leaves its owner."""
        cfg = cfg if cfg is not None else S.SearchConfig()
        qx = None
        if cfg.quant.is_coded:
            if self.qx is None:
                raise ValueError(
                    f"search config requests quant mode {cfg.quant.mode!r} but the index "
                    "holds no codes: build with a coded cfg.quant (or set .qx from "
                    "repro_torch.quant.encode_corpus)")
            if self.qx.mode != cfg.quant.mode:
                raise ValueError(
                    f"search config requests quant mode {cfg.quant.mode!r} but the index "
                    f"codes are {self.qx.mode!r}")
            qx = self.qx
        queries = as_tensor(queries, self.x.device, torch.float32)
        if not self._corpus_sharded:
            if entry_points is None:
                entry_points = S.default_entry_point(self.x, cfg.metric)
            return S.search_tiled(self.x, self.graph, queries, entry_points, cfg,
                                  tile_b=tile_b, qx=qx, mesh=self.mesh, shard="queries")
        from repro_torch.core import search_sharded as SS
        if entry_points is None:
            entry_points = self.entries[cfg.metric]
        eps = S._validate_entry_points(entry_points, queries.shape[0], cfg.l, self.x.device)
        return SS.search_tiled_corpus(self.x, self.graph.neighbors, queries, eps, cfg,
                                      tile_b, self.mesh, n=self.n, qx=qx)

    # ------------------------------------------------------------ persistence
    def _whole(self):
        """(graph, qx) whole, gathered from the ranks' blocks if need be."""
        if not self._corpus_sharded:
            return self.graph, self.qx
        from repro_torch.core import shard as SHD
        from repro_torch.distributed import comm as C
        g = SHD.gather_rows(self.graph, self.n, self.mesh)
        qx = self.qx
        if qx is not None:
            codes = C.all_gather(qx.codes, self.mesh, SHD.row_axes(self.mesh))[:self.n]
            qx = qx._replace(codes=codes)
        return g, qx

    def save(self, ckpt_dir: str, step: int = 0) -> None:
        """Atomic-commit save of the whole graph, plus the codes when
        present; a bare graph when there are none (the reference's layouts).
        Under a mesh rank 0 writes and every rank returns once it has."""
        g, qx = self._whole()
        if self.mesh is None or self.mesh.rank == 0:
            checkpoint.save(ckpt_dir, step, g if qx is None else {"graph": g, "qx": qx})
        if self.mesh is not None:
            from repro_torch.distributed import comm as C
            C.psum(torch.zeros((), device=self.mesh.device), self.mesh, self.mesh.axis_names)

    @classmethod
    def restore(cls, ckpt_dir: str, x, mesh=None, step: int | None = None,
                method: str = "rnn-descent", serve_shard: str = "queries",
                device: str | torch.device = "cuda") -> "ShardedANN":
        """Elastic restore: load the committed graph (and codes, if the
        checkpoint holds any) and place them on ``mesh`` (any shape, not
        necessarily the one it was saved from) or, without one, on
        ``device``. ``x``: the whole corpus, on every rank."""
        if step is None:
            step = checkpoint.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
        dev = mesh.device if mesh is not None else resolve_device(device)
        x = as_tensor(x, dev, torch.float32)
        # probe the manifest: coded saves are a {"graph", "qx"} dict (leaf
        # names like "['qx'].codes"), plain saves a bare Graph
        names = set(checkpoint.manifest_names(ckpt_dir, step))
        if any(nm.startswith("['qx']") for nm in names):
            if "['qx'].codebooks" in names:
                qx_like = QuantizedCorpus(codes=0, codebooks=0)
            else:
                qx_like = QuantizedCorpus(codes=0, scale=0, zero=0)
            like = {"graph": G.Graph(neighbors=0, dists=0, flags=0), "qx": qx_like}
            tree = checkpoint.restore(ckpt_dir, step, like, device=dev)
            g, qx = tree["graph"], tree["qx"]
        else:
            g = checkpoint.restore(ckpt_dir, step, G.Graph(neighbors=0, dists=0, flags=0),
                                   device=dev)
            qx = None
        return cls(x=x, graph=g, mesh=mesh, method=method, qx=qx,
                   serve_shard=serve_shard)._placed()
