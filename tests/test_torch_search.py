"""Port parity: beam scoring and beam search against the reference (JAX,
CPU, jnp paths).

Scoring on float data is held to 1e-5 (the d-reductions sum in another
order). Search runs on an integer corpus, where every l2/ip distance is exact
in f32, so dense search ids, distances and work counters must equal the
reference's bit for bit, ties included (both sides break them toward the
lower index). Hashed search is held against the port's own dense search:
which of two ids racing for one hash slot wins differs between XLA and
PyTorch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.kernels.beam_score.ref import beam_score_ref as ref_beam_score_ref
from repro.kernels.beam_score.ref import score_block as ref_score_block
from repro_torch import convert
from repro_torch.core import graph as G
from repro_torch.core import search as S
from repro_torch.kernels.beam_score import ops as bs_ops
from repro_torch.kernels.beam_score.ref import score_block

torch.set_num_threads(1)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_score_block_matches_reference(metric):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((6, 9, 24)).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    ref = np.asarray(ref_score_block(jnp.asarray(vecs), jnp.asarray(q), metric))
    out = score_block(torch.from_numpy(vecs), torch.from_numpy(q), metric).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_matches_reference(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    nbrs = rng.integers(-1, 50, (50, 12)).astype(np.int32)
    u = rng.integers(0, 50, 20).astype(np.int32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    rids, rd, rkeys = ref_beam_score_ref(jnp.asarray(x), jnp.asarray(nbrs), jnp.asarray(u),
                                         jnp.asarray(q), k=8, metric=metric)
    ids, d, keys = bs_ops.beam_score(*(torch.from_numpy(a) for a in (x, nbrs, u, q)),
                                     k=8, metric=metric)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)
    # keys decode exactly to the port's distances, and to the reference's
    # keys wherever the distances agree bit for bit
    np.testing.assert_array_equal(G.key_dist(keys).numpy(), d.numpy())
    same = d.numpy() == np.asarray(rd)
    np.testing.assert_array_equal(convert.key_to_reference(keys)[same], np.asarray(rkeys)[same])
    # k is clipped to the capacity
    assert bs_ops.beam_score(*(torch.from_numpy(a) for a in (x, nbrs, u, q)), k=99,
                             metric=metric)[0].shape == (20, 12)


@pytest.fixture(scope="module")
def int_index():
    """Reference-built graph over an integer corpus, plus its entry points."""
    rng = np.random.default_rng(2)
    x = rng.integers(-8, 9, (600, 16)).astype(np.float32)
    q = rng.integers(-8, 9, (70, 16)).astype(np.float32)
    out = {}
    for metric in ("l2", "ip"):
        cfg = RRD.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128,
                                   metric=metric)
        g = RRD.build(jnp.asarray(x), cfg, jax.random.PRNGKey(1))
        eps = np.asarray(RS.default_entry_points(jnp.asarray(x), 3, metric))
        out[metric] = (g, eps)
    return x, q, out


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dense_search_matches_reference_exactly(int_index, metric):
    x, q, graphs = int_index
    g, eps = graphs[metric]
    eps_b = np.broadcast_to(eps[None], (q.shape[0], eps.shape[0]))
    cfg = RS.SearchConfig(l=16, k=12, max_iters=48, topk=5, metric=metric, visited="dense")
    rids, rdist, rstats = RS.search_tiled(jnp.asarray(x), g, jnp.asarray(q),
                                          jnp.asarray(eps_b), cfg, tile_b=32, with_stats=True)
    pcfg = S.SearchConfig(l=16, k=12, max_iters=48, topk=5, metric=metric, visited="dense")
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    ids, dist, stats = S.search_tiled(torch.from_numpy(x), pg, torch.from_numpy(q),
                                      torch.from_numpy(eps_b.copy()), pcfg, tile_b=32,
                                      with_stats=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))
    assert stats["work"] == int(rstats["work"])
    assert stats["launched"] == int(rstats["launched"])
    assert (stats["tiles"], stats["tile_lanes"]) == (rstats["tiles"], rstats["tile_lanes"])
    # search() is search_tiled with one tile
    one, _ = S.search(torch.from_numpy(x), pg, torch.from_numpy(q),
                      torch.from_numpy(eps_b.copy()), pcfg)
    np.testing.assert_array_equal(one.numpy(), np.asarray(rids))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_hashed_search_equals_port_dense(int_index, metric):
    x, q, graphs = int_index
    g, eps = graphs[metric]
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    cfg = S.SearchConfig(l=16, k=12, max_iters=64, topk=5, metric=metric, visited="dense")
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    dense, dd = S.search_tiled(xt, pg, qt, int(eps[0]), cfg, tile_b=32)
    for slots in (None, 64):   # default table, and a small one that loses inserts
        hashed, hd = S.search_tiled(xt, pg, qt, int(eps[0]),
                                    dataclasses.replace(cfg, visited="hashed", slots=slots),
                                    tile_b=32)
        torch.testing.assert_close(hashed, dense, rtol=0, atol=0)
        torch.testing.assert_close(hd, dd, rtol=0, atol=0)


def test_lane_valid_and_padding_do_not_change_live_lanes(int_index):
    x, q, graphs = int_index
    g, eps = graphs["l2"]
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    cfg = S.SearchConfig(l=16, k=12, max_iters=48, topk=5)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    full, _ = S.search_tiled(xt, pg, qt, int(eps[0]), cfg, tile_b=70)
    lv = torch.arange(q.shape[0]) % 3 != 0
    part, _, st = S.search_tiled(xt, pg, qt, int(eps[0]), cfg, tile_b=16, lane_valid=lv,
                                 with_stats=True)
    torch.testing.assert_close(part[lv], full[lv], rtol=0, atol=0)
    assert st["tiles"] == 5 and st["tile_lanes"] == 16


def test_search_config_validation_matches_reference():
    bad = [dict(metric="hamming"), dict(gram_dtype="f16"), dict(l=0), dict(topk=9, l=8),
           dict(visited="bloom"), dict(probes=0), dict(slots=12), dict(slots=4)]
    for kw in bad:
        with pytest.raises(ValueError):
            RS.SearchConfig(**kw)
        with pytest.raises(ValueError):
            S.SearchConfig(**kw)


def test_entry_point_validation_matches_reference():
    x = torch.zeros(10, 4)
    for eps in (np.zeros(3, np.int32), np.zeros((4, 2), np.int32),
                np.zeros((5, 9), np.int32), np.zeros((5, 1, 1), np.int32)):
        with pytest.raises(ValueError):
            RS._validate_entry_points(jnp.asarray(eps), 5, 8)
        with pytest.raises(ValueError):
            S._validate_entry_points(eps, 5, 8, x.device)
    assert S._validate_entry_points(3, 5, 8, x.device).shape == (5, 1)
    with pytest.raises(ValueError, match="n_entries"):
        S.default_entry_points(x, 11)
    with pytest.raises(ValueError, match="lane_valid"):
        g = G.empty_graph(10, 4, "cpu")
        S.search_tiled(x, g, torch.zeros(5, 4), 0, S.SearchConfig(), lane_valid=torch.ones(4))


def test_default_entry_point_matches_reference():
    x = np.random.default_rng(3).standard_normal((200, 8)).astype(np.float32)
    for metric in ("l2", "ip", "cos"):
        assert int(S.default_entry_point(torch.from_numpy(x), metric)) == \
            int(RS.default_entry_point(jnp.asarray(x), metric))
    eps = S.default_entry_points(torch.from_numpy(x), 5).numpy()
    assert len(set(eps.tolist())) == 5 and eps[0] == int(RS.default_entry_point(jnp.asarray(x)))


def test_probe_slots_match_reference():
    ids = np.array([-1, 0, 1, 7, 123456, 2**31 - 1], np.int32)
    ref = np.asarray(RS._probe_slots(jnp.asarray(ids), 1024, 8))
    np.testing.assert_array_equal(S._probe_slots(torch.from_numpy(ids), 1024, 8).numpy(), ref)
    assert S.resolve_slots(S.SearchConfig(l=64, k=64), 1) == \
        RS.resolve_slots(RS.SearchConfig(l=64, k=64), 1)
