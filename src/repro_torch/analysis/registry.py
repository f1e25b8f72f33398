"""Entry-point registry for the dispatch audit (the port's counterpart of
``repro.analysis.registry``).

Every public entry point of the port is registered here as a *setup*
function: it builds the entry's inputs (untraced) at the reference's tiny
size — ``N, D, M, B = 32, 8, 16, 4`` on the CPU — and returns the one call
the audit records. The audited properties (dtype discipline, host syncs)
do not depend on the size, so a 32 x 8 corpus goes through the same aten
ops as a production build; on the CPU the kernel wrappers run their plain
versions, which are the kernels' contracts.

Registering a new entry point (the checklist for a change that adds one):

1. Add a ``def _<name>():`` setup below returning a zero-argument call.
2. Add it to ``_REGISTRY`` under ``"<module>/<name>"`` (plus ``@<variant>``
   for each corpus mode or visited mode it takes).
3. Run ``python -m repro_torch.analysis --passes dispatch``: a clean entry
   adds no findings; a dirty one fails the gate until fixed (or
   consciously baselined with ``--write-baseline``).
"""
from __future__ import annotations

import numpy as np
import torch

N, D, M, B = 32, 8, 16, 4     # corpus rows/dims, adjacency cap, query batch


def _x() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).standard_normal((N, D)).astype(np.float32))


def _queries() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(1).standard_normal((B, D)).astype(np.float32))


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _quant(mode: str | None):
    from repro_torch.quant import Quantization
    if mode is None:
        return Quantization()
    return Quantization(mode=mode, m=2, rerank_k=4) if mode == "pq" else \
        Quantization(mode=mode, rerank_k=4)


def _rnn_cfg(**kw):
    from repro_torch.core import rnn_descent as rd
    return rd.RNNDescentConfig(**{"s": 4, "r": 8, "t1": 2, "t2": 2, "capacity": M,
                                  "chunk": 16, **kw})


def _nn_cfg(**kw):
    from repro_torch.core import nn_descent as nnd
    return nnd.NNDescentConfig(**{"k": 8, "s": 4, "iters": 2, **kw})


def _search_cfg(**kw):
    from repro_torch.core import search as S
    return S.SearchConfig(**{"l": 8, "k": 4, "max_iters": 8, "topk": 2, **kw})


# ------------------------------------------------------ graph construction
def _rnn_build(quant=None):
    def setup():
        from repro_torch.core import rnn_descent as rd
        x, cfg = _x(), _rnn_cfg(quant=_quant(quant))
        return lambda: rd.build(x, cfg, _gen())
    return setup


def _nn_build():
    from repro_torch.core import nn_descent as nnd
    x, cfg = _x(), _nn_cfg()
    return lambda: nnd.build(x, cfg, _gen())


def _nsg_build():
    from repro_torch.core import nsg_style as nsg
    x = _x()
    cfg = nsg.NSGStyleConfig(r=4, c=8, knn=_nn_cfg(iters=1))
    return lambda: nsg.build(x, cfg, _gen())


# ------------------------------------------------------------------- search
def _search(tiled: bool, quant=None, visited="dense"):
    def setup():
        from repro_torch.core import rnn_descent as rd
        from repro_torch.core import search as S
        from repro_torch.quant import encode_corpus
        x, q = _x(), _queries()
        q_mode = _quant(quant)
        g = rd.build(x, _rnn_cfg(), _gen())
        cfg = _search_cfg(quant=q_mode, visited=visited)
        qx = encode_corpus(x, q_mode) if q_mode.is_coded else None
        if tiled:
            return lambda: S.search_tiled(x, g, q, 0, cfg, tile_b=2, with_stats=True, qx=qx)
        return lambda: S.search(x, g, q, 0, cfg, qx=qx)
    return setup


# ---------------------------------------------------------------- streaming
def _stream(op: str):
    def setup():
        from repro_torch.streaming import StreamingANN, StreamingConfig
        cfg = StreamingConfig(build=_rnn_cfg(), seed_l=16, seed_k=8, seed_iters=16,
                              search_k=8, batch_k=2, sweeps=1, splice_k=4, delete_fanout=8)
        x = _x()
        ann = StreamingANN.from_corpus(x[:N - B], cfg, generator=_gen(), capacity=2 * N,
                                       device="cpu")
        if op == "insert":
            return lambda: ann.insert(x[N - B:])
        return lambda: ann.delete(np.arange(B))
    return setup


# --------------------------------------------------------- the paper's cells
def _bound(shape_name: str):
    def setup():
        from repro_torch.core import rnn_descent as rd
        from repro_torch.launch import steps
        b = steps.bind("rnnd-ann", shape_name, reduced=True, device="cpu")
        x = _x()
        if b.kind == "ann_build":
            return lambda: b.step_fn({}, {"x": x, "generator": _gen()})
        g = rd.build(x, b.cfg, _gen())
        batch = {"x": x, "neighbors": g.neighbors, "dists": g.dists, "queries": _queries()}
        return lambda: b.step_fn({}, batch)
    return setup


# ------------------------------------------------------- training and the LM
def _cell(arch_id: str, shape_name: str):
    """A bound step of ``arch_id``'s SMOKE config at ``compute_dtype=float32``
    (so a bf16 product anywhere is a finding) on its smoke batch; train
    steps update their state in place, call after call."""
    def setup():
        import dataclasses

        from repro_torch import configs
        from repro_torch.configs import base as cb
        from repro_torch.launch import steps
        arch = configs.get(arch_id)
        cfg = dataclasses.replace(arch.make_config(shape_name, True),
                                  compute_dtype=torch.float32)
        b = steps.bind_with_cfg(arch_id, shape_name, cfg, device="cpu")
        batch = cb.smoke_batch(arch.family)(_gen(), cfg, b.shape, "cpu")
        state = b.init_fn(_gen())
        return lambda: b.step_fn(state, batch)
    return setup


_REGISTRY = {
    "core/rnn_descent.build": _rnn_build(),
    "core/rnn_descent.build@int8": _rnn_build("int8"),
    "core/nn_descent.build": _nn_build,
    "core/nsg_style.build": _nsg_build,
    "core/search.search": _search(False),
    "core/search.search@hashed": _search(False, visited="hashed"),
    "core/search.search@int8": _search(False, "int8"),
    "core/search.search@pq": _search(False, "pq"),
    "core/search.search_tiled": _search(True),
    "core/search.search_tiled@hashed": _search(True, visited="hashed"),
    "core/search.search_tiled@int8": _search(True, "int8"),
    "core/search.search_tiled@pq": _search(True, "pq"),
    "core/search.search_tiled@int8-hashed": _search(True, "int8", "hashed"),
    "core/search.search_tiled@pq-hashed": _search(True, "pq", "hashed"),
    "streaming/index.insert": _stream("insert"),
    "streaming/index.delete": _stream("delete"),
    "launch/steps.rnnd-ann.build_1m": _bound("build_1m"),
    "launch/steps.rnnd-ann.build_gist": _bound("build_gist"),
    "launch/steps.rnnd-ann.search_1m": _bound("search_1m"),
    # FM: DeepFM's deep tower is bf16 whatever compute_dtype says (nn.mlp's
    # default, as in the reference), which the f32 rule would flag
    "launch/steps.fm.train_batch": _cell("fm", "train_batch"),
    "launch/steps.minitron-4b.train_4k": _cell("minitron-4b", "train_4k"),
    "launch/steps.minitron-4b.prefill_32k": _cell("minitron-4b", "prefill_32k"),
    "launch/steps.minitron-4b.decode_32k": _cell("minitron-4b", "decode_32k"),
    "launch/steps.dimenet.full_graph_sm": _cell("dimenet", "full_graph_sm"),
    "launch/steps.dimenet.minibatch_lg": _cell("dimenet", "minibatch_lg"),
    "launch/steps.dimenet.ogb_products": _cell("dimenet", "ogb_products"),
    "launch/steps.dimenet.molecule": _cell("dimenet", "molecule"),
}


def entries(names: list[str] | None = None) -> dict:
    """name -> setup (returning the call to audit). ``names`` filters by
    exact match or substring (``--only search`` selects every search
    variant)."""
    reg = dict(_REGISTRY)
    if names:
        reg = {k: v for k, v in reg.items() if any(s == k or s in k for s in names)}
    return reg
