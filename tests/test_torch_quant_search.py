"""Port parity: beam search over coded corpora (int8, PQ) with the exact-f32
rerank tail, against the reference (JAX, CPU, jnp paths).

Dense-visited search runs on an integer corpus whose code spaces are exact
in f32 (int8: scale 1/2, zero 0, so the decoded rows are half-integers; PQ:
integer codebooks): every coded and exact distance is then computed without
rounding on both sides, so ids, distances and work counters must be equal,
ties included. Hashed search is held against the port's own dense search
(which of two ids racing for one hash slot wins differs between XLA and
PyTorch). End to end, the port's own encode + build + search is held to the
reference's recall@10 within 0.02 (different random initial graphs and PQ
initial rows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as RQ
from repro.core import eval as RE
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro_torch import convert
from repro_torch import quant as Q
from repro_torch.core import eval as E
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def coded_index():
    """An integer corpus, a reference-built graph per metric, and exact
    int8 and PQ code spaces of the corpus (reference arrays)."""
    rng = np.random.default_rng(12)
    x = rng.integers(-8, 9, (600, 16)).astype(np.float32)
    q = rng.integers(-8, 9, (70, 16)).astype(np.float32)
    graphs = {}
    for metric in ("l2", "ip"):
        cfg = RRD.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128,
                                   metric=metric)
        g = RRD.build(jnp.asarray(x), cfg, jax.random.PRNGKey(1))
        eps = np.asarray(RS.default_entry_points(jnp.asarray(x), 3, metric))
        graphs[metric] = (g, np.broadcast_to(eps[None], (q.shape[0], 3)).copy())
    jitter = rng.integers(-1, 2, x.shape)
    qx = {"int8": RQ.QuantizedCorpus(codes=jnp.asarray((2 * x + jitter).astype(np.int8)),
                                     scale=jnp.full((16,), 0.5, jnp.float32),
                                     zero=jnp.zeros((16,), jnp.float32))}
    cb = jnp.asarray(rng.integers(-8, 9, (4, 256, 4)).astype(np.float32))
    qx["pq"] = RQ.QuantizedCorpus(codes=RQ.encode_pq_rows(jnp.asarray(x), cb), codebooks=cb)
    return x, q, graphs, qx


def _cfgs(mode, metric, rerank_k, visited="dense", **kw):
    common = dict(l=80, k=12, max_iters=120, topk=5, metric=metric, visited=visited, **kw)
    m = dict(m=4) if mode == "pq" else {}
    return (RS.SearchConfig(quant=RQ.Quantization(mode=mode, rerank_k=rerank_k, **m), **common),
            S.SearchConfig(quant=Q.Quantization(mode=mode, rerank_k=rerank_k, **m), **common))


@pytest.mark.parametrize("rerank_k", [64, 0])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_coded_dense_search_matches_reference_exactly(coded_index, mode, metric, rerank_k):
    x, q, graphs, qx = coded_index
    g, eps = graphs[metric]
    rcfg, pcfg = _cfgs(mode, metric, rerank_k)
    rids, rdist, rstats = RS.search_tiled(jnp.asarray(x), g, jnp.asarray(q), jnp.asarray(eps),
                                          rcfg, tile_b=32, qx=qx[mode], with_stats=True)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    pqx = convert.quantized_from_numpy(qx[mode], device="cpu")
    xt, qt, et = (torch.from_numpy(a) for a in (x, q, eps))
    ids, dist, stats = S.search_tiled(xt, pg, qt, et, pcfg, tile_b=32, qx=pqx,
                                      with_stats=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))
    assert stats["work"] == int(rstats["work"])
    assert stats["launched"] == int(rstats["launched"])
    one, one_d = S.search(xt, pg, qt, et, pcfg, qx=pqx)     # one tile
    np.testing.assert_array_equal(one.numpy(), np.asarray(rids))
    if rerank_k:   # the tail returns exact f32 distances to x
        from repro_torch.kernels.beam_score.ref import score_block
        ok = one >= 0
        exact = score_block(xt[one.clamp(min=0).long()], qt, metric)
        torch.testing.assert_close(one_d[ok], exact[ok], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_coded_hashed_search_equals_port_dense(coded_index, mode):
    x, q, graphs, qx = coded_index
    g, eps = graphs["l2"]
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    pqx = convert.quantized_from_numpy(qx[mode], device="cpu")
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    _, cfg = _cfgs(mode, "l2", 64)
    dense, dd = S.search_tiled(xt, pg, qt, int(eps[0, 0]), cfg, tile_b=32, qx=pqx)
    for slots in (None, 64):   # default table, and a small one that loses inserts
        hashed, hd = S.search_tiled(xt, pg, qt, int(eps[0, 0]),
                                    dataclasses.replace(cfg, visited="hashed", slots=slots),
                                    tile_b=32, qx=pqx)
        torch.testing.assert_close(hashed, dense, rtol=0, atol=0)
        torch.testing.assert_close(hd, dd, rtol=0, atol=0)


def test_coded_search_without_codes_raises(coded_index):
    x, q, graphs, _ = coded_index
    g, eps = graphs["l2"]
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    for mode in ("int8", "pq"):
        rcfg, pcfg = _cfgs(mode, "l2", 64)
        with pytest.raises(ValueError, match="qx"):
            RS.search(jnp.asarray(x), g, jnp.asarray(q), jnp.asarray(eps), rcfg)
        with pytest.raises(ValueError, match="qx"):
            S.search(xt, pg, qt, int(eps[0, 0]), pcfg)
        with pytest.raises(ValueError, match="qx"):
            S.search_tiled(xt, pg, qt, int(eps[0, 0]), pcfg)


def test_coded_config_validation_matches_reference():
    bad = [dict(quant=dict(mode="int8"), gram_dtype="bf16"),
           dict(quant=dict(mode="pq", rerank_k=3), topk=5),
           dict(quant="int8")]
    for kw in bad:
        rq = kw.get("quant")
        rkw = dict(kw, quant=RQ.Quantization(**rq) if isinstance(rq, dict) else rq)
        pkw = dict(kw, quant=Q.Quantization(**rq) if isinstance(rq, dict) else rq)
        with pytest.raises(ValueError):
            RS.SearchConfig(**rkw)
        with pytest.raises(ValueError):
            S.SearchConfig(**pkw)
        if "topk" not in kw:
            with pytest.raises(ValueError):
                RRD.RNNDescentConfig(**rkw)
            with pytest.raises(ValueError):
                rd.RNNDescentConfig(**pkw)
    # rerank_k = 0 disables the tail whatever topk is; bf16 mode picks the bf16 gather
    S.SearchConfig(topk=5, quant=Q.Quantization(mode="pq", rerank_k=0))
    assert S.SearchConfig(quant=Q.Quantization(mode="bf16")).effective_gram_dtype == "bf16"
    assert rd.RNNDescentConfig(quant=Q.Quantization(mode="bf16")).effective_gram_dtype == "bf16"


# the configuration of tests/test_recall_regression.py (rnn-descent row)
BUILD = dict(s=8, r=24, t1=3, t2=4, capacity=32, chunk=256)
SEARCH = dict(l=32, k=24, max_iters=96, topk=10)


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_coded_build_search_recall_matches_reference(small_dataset, mode):
    """Each side encodes, builds over its decoded corpus and searches its
    codes with the rerank tail; recall@10 within 0.02 of the reference's."""
    x, q, gt = small_dataset
    extra = dict(m=12) if mode == "pq" else {}
    rquant, pquant = RQ.Quantization(mode=mode, **extra), Q.Quantization(mode=mode, **extra)
    eps = RS.default_entry_point(x)
    g_ref = RRD.build(x, RRD.RNNDescentConfig(**BUILD, quant=rquant), jax.random.PRNGKey(1))
    ids_ref, _ = RS.search_tiled(x, g_ref, q, eps, RS.SearchConfig(**SEARCH, quant=rquant),
                                 tile_b=64, qx=RQ.encode_corpus(x, rquant))
    r_ref = RE.recall_topk(ids_ref, gt)

    xt, qt, gtt = (torch.from_numpy(np.array(a)) for a in (x, q, gt))
    g = rd.build(xt, rd.RNNDescentConfig(**BUILD, quant=pquant), torch.Generator().manual_seed(1))
    ids, dists = S.search_tiled(xt, g, qt, int(eps), S.SearchConfig(**SEARCH, quant=pquant),
                                tile_b=64, qx=Q.encode_corpus(xt, pquant))
    r = E.recall_topk(ids, gtt)
    assert abs(r - r_ref) <= 0.02, (r, r_ref)
    assert (ids >= 0).all() and (torch.diff(dists, dim=1) >= 0).all()
    assert all(len(set(row.tolist())) == row.numel() for row in ids)


@pytest.mark.parametrize("rerank_k", [64, 0])
@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_coded_search_valid_mask_matches_reference(coded_index, mode, rerank_k):
    """The tombstone mask in the coded tails (the rerank's, and the plain
    one without rerank): masked ids leave the rerank window and never
    surface; bit for bit the reference; an all-true mask equals no mask."""
    x, q, graphs, qx = coded_index
    g, eps = graphs["l2"]
    rcfg, pcfg = _cfgs(mode, "l2", rerank_k)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    pqx = convert.quantized_from_numpy(qx[mode], device="cpu")
    xt, qt, et = (torch.from_numpy(a) for a in (x, q, eps))
    valid = np.random.default_rng(21).random(x.shape[0]) < 0.6
    rids, rdist = RS.search_tiled(jnp.asarray(x), g, jnp.asarray(q), jnp.asarray(eps), rcfg,
                                  tile_b=32, qx=qx[mode], valid=jnp.asarray(valid))
    ids, dist = S.search_tiled(xt, pg, qt, et, pcfg, tile_b=32, qx=pqx,
                               valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))
    got = ids.numpy()
    assert not np.isin(got[got >= 0], np.flatnonzero(~valid)).any()
    base = S.search_tiled(xt, pg, qt, et, pcfg, tile_b=32, qx=pqx)
    full = S.search_tiled(xt, pg, qt, et, pcfg, tile_b=32, qx=pqx,
                          valid=torch.ones(x.shape[0], dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(base, full))
