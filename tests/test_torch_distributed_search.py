"""Port parity of the sharded searches and of ``ShardedANN`` on gloo CPU
ranks, against the reference's single-device search (JAX, CPU).

Groups of 2 and 4 ranks (``tests/_dist_workers``; the children import torch
and repro_torch alone) run ``search_tiled(mesh=, shard="queries")`` and
``shard="corpus"`` with dense visited on the reference's graph of an
integer corpus of N = 701 rows, 37 queries (neither divides by the ranks):
one entry point, and three entry points with a ``valid=`` mask; l2 and ip;
and the exact int8 and PQ code spaces of ``tests/test_torch_quant_search.py``
with the rerank tail. Every distance is exact in f32, so ids, distances and
lane work are equal to the reference's bit for bit. ``ShardedANN``: built
and saved on 4 ranks, restored on 2 and on none, it serves the same
results; a checkpoint the reference's ``ShardedANN`` wrote restores into the
port's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
from repro import quant as RQ
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.distributed.ann import ShardedANN as RShardedANN
from repro_torch import convert
from repro_torch import quant as Q
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.distributed.ann import ShardedANN

torch.set_num_threads(1)

N, DIM, B = 701, 16, 37
SEARCH = dict(l=24, k=16, max_iters=80, topk=5, visited="dense")
CASES = ["l2_one", "ip_one", "l2_multi_valid", "ip_multi_valid"]
CODED = ["int8", "pq"]


def _scfgs(metric, quant=None, **kw):
    rq = RQ.Quantization(**quant) if quant else RQ.Quantization()
    pq = Q.Quantization(**quant) if quant else Q.Quantization()
    return (RS.SearchConfig(**SEARCH, metric=metric, quant=rq, **kw),
            S.SearchConfig(**SEARCH, metric=metric, quant=pq, **kw))


@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(21)
    x = rng.integers(-8, 9, (N, DIM)).astype(np.float32)
    q = rng.integers(-8, 9, (B, DIM)).astype(np.float32)
    xj, xt, qt = jnp.asarray(x), torch.from_numpy(x), torch.from_numpy(q)
    cfg = RRD.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128)
    g = RRD.build(xj, cfg, jax.random.PRNGKey(1))
    valid = rng.random(N) > 0.2
    cases, ref = {}, {}
    for metric in ("l2", "ip"):
        rc, pc = _scfgs(metric)
        ep = int(RS.default_entry_point(xj, metric))
        ids, d, st = RS.search_tiled(xj, g, jnp.asarray(q), ep, rc, tile_b=8, with_stats=True)
        ref[f"{metric}_one"] = (ids, d, int(st["work"]))
        cases[f"{metric}_one"] = (qt, ep, pc, None)
        eps = np.broadcast_to(np.asarray(RS.default_entry_points(xj, 3, metric))[None],
                              (B, 3)).copy()
        ids, d, st = RS.search_tiled(xj, g, jnp.asarray(q), jnp.asarray(eps), rc, tile_b=8,
                                     valid=jnp.asarray(valid), with_stats=True)
        ref[f"{metric}_multi_valid"] = (ids, d, int(st["work"]))
        cases[f"{metric}_multi_valid"] = (qt, torch.from_numpy(eps), pc, torch.from_numpy(valid))
    # exact code spaces: int8 scale 1/2, zero 0; PQ with integer codebooks
    jitter = rng.integers(-1, 2, x.shape)
    rqx = {"int8": RQ.QuantizedCorpus(codes=jnp.asarray((2 * x + jitter).astype(np.int8)),
                                      scale=jnp.full((DIM,), 0.5, jnp.float32),
                                      zero=jnp.zeros((DIM,), jnp.float32))}
    cb = jnp.asarray(rng.integers(-8, 9, (4, 256, 4)).astype(np.float32))
    rqx["pq"] = RQ.QuantizedCorpus(codes=RQ.encode_pq_rows(xj, cb), codebooks=cb)
    coded = {}
    for mode in CODED:
        quant = dict(mode=mode, rerank_k=12, **({"m": 4} if mode == "pq" else {}))
        rc, pc = _scfgs("l2", quant)
        ep = int(RS.default_entry_point(xj, "l2"))
        ref[mode] = RS.search_tiled(xj, g, jnp.asarray(q), ep, rc, tile_b=8, qx=rqx[mode])
        coded[mode] = (qt, ep, pc, convert.quantized_from_numpy(tuple(rqx[mode]), device="cpu"))
    gt = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    return xt, gt, cases, coded, ref


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, reference):
    xt, gt, cases, coded, _ = reference
    return W.run(W.searches, request.param, xt, gt, cases, coded)


def _equal(got, ref):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("shard", ["queries", "corpus"])
@pytest.mark.parametrize("case", CASES)
def test_sharded_search_matches_reference(ranks, reference, case, shard):
    ref = reference[4][case]
    for res in ranks:            # every rank returns the whole batch
        got = res[case, shard]
        _equal(got, ref)
        assert got[2] == ref[2]  # lane work, tiling-invariant


@pytest.mark.parametrize("shard", ["queries", "corpus"])
@pytest.mark.parametrize("mode", CODED)
def test_sharded_coded_search_matches_reference(ranks, reference, mode, shard):
    for res in ranks:
        _equal(res[mode, shard], reference[4][mode])


@pytest.fixture(scope="module")
def ann_runs(reference, tmp_path_factory):
    """ShardedANN built and saved on 4 ranks (corpus-sharded), restored on
    2 ranks (both placements) and on none."""
    xt = reference[0]
    q = xt[:B] + 0.5
    cfg = rd.RNNDescentConfig(s=8, r=16, t1=2, t2=2, capacity=24, chunk=128)
    scfg = S.SearchConfig(**SEARCH)
    ckpt = str(tmp_path_factory.mktemp("ann"))
    built = W.run(W.ann_build_save, 4, xt, cfg, q, scfg, ckpt)
    restored = W.run(W.ann_restore, 2, xt, q, scfg, ckpt)
    single = ShardedANN.restore(ckpt, xt, device="cpu")
    return built, restored, single.search(q, scfg, tile_b=8), single


def test_sharded_ann_restores_on_other_meshes(ann_runs):
    built, restored, single, _ = ann_runs
    for res in built:
        assert torch.equal(res["ids"], single[0]) and torch.equal(res["dists"], single[1])
    for res in restored:
        for sh in ("corpus", "queries"):
            assert torch.equal(res[sh][0], single[0]) and torch.equal(res[sh][1], single[1])


def test_sharded_ann_corpus_placement_holds_a_block(ann_runs):
    """4-way corpus placement: ceil(701 / 4) = 176 rows a rank; 2-way: 351;
    the replicated placement holds the whole index."""
    built, restored, _, single = ann_runs
    whole = single.device_resident_bytes()
    per_row = whole // N
    assert all(res["rows"] == 176 for res in built)
    assert all(res["resident"] == 176 * per_row for res in built)
    assert all(res["corpus", "resident"] == 351 * per_row for res in restored)
    assert all(res["queries", "resident"] == whole for res in restored)


def test_reference_checkpoint_restores_into_the_port(reference, tmp_path):
    """The reference's ShardedANN (no mesh) saves; the port restores the same
    graph and serves the reference's results."""
    xt, _, cases, _, _ = reference
    x = jnp.asarray(xt.numpy())
    cfg = RRD.RNNDescentConfig(s=8, r=16, t1=2, t2=2, capacity=24, chunk=128)
    rann = RShardedANN.build(x, "rnn-descent", cfg, jax.random.PRNGKey(2))
    rann.save(str(tmp_path))
    ann = ShardedANN.restore(str(tmp_path), xt, device="cpu")
    for a, b in zip(ann.graph, rann.graph):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rc, pc = _scfgs("l2")
    q = cases["l2_one"][0]
    want = rann.search(jnp.asarray(q.numpy()), rc, tile_b=8)
    got = ann.search(q, pc, tile_b=8)
    _equal(got, want)


def test_sharded_ann_validates_its_arguments(reference):
    xt, gt, _, coded, _ = reference
    with pytest.raises(ValueError):
        ShardedANN(x=xt, graph=gt, serve_shard="rows")._placed()
    ann = ShardedANN(x=xt, graph=gt)._placed()
    with pytest.raises(ValueError):          # coded search without codes
        ann.search(xt[:3], dataclasses.replace(coded["int8"][2]))
