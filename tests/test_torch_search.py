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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_matches_reference(metric, dtype):
    """f32 rows, or bf16 rows (the reference's gram_dtype="bf16": rows cast
    to bf16, every sum f32). Float data within 1e-5; integer-valued rows
    and queries bit for bit (ids, l2/ip distances and keys)."""
    rng = np.random.default_rng(1)
    cast = torch.bfloat16 if dtype == "bf16" else torch.float32

    def both(x, nbrs, u, q, k):
        ref = ref_beam_score_ref(jnp.asarray(x), jnp.asarray(nbrs), jnp.asarray(u),
                                 jnp.asarray(q), k=k, metric=metric, gram_dtype=dtype)
        out = bs_ops.beam_score(torch.from_numpy(x).to(cast),
                                *(torch.from_numpy(a) for a in (nbrs, u, q)), k=k,
                                metric=metric)
        return [np.asarray(a) for a in ref], out

    x = rng.standard_normal((50, 16)).astype(np.float32)
    nbrs = rng.integers(-1, 50, (50, 12)).astype(np.int32)
    u = rng.integers(0, 50, 20).astype(np.int32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    (rids, rd, rkeys), (ids, d, keys) = both(x, nbrs, u, q, 8)
    np.testing.assert_array_equal(ids.numpy(), rids)
    np.testing.assert_allclose(d.numpy(), rd, rtol=1e-5, atol=1e-5)
    # keys decode exactly to the port's distances, and to the reference's
    # keys wherever the distances agree bit for bit
    np.testing.assert_array_equal(G.key_dist(keys).numpy(), d.numpy())
    same = d.numpy() == rd
    np.testing.assert_array_equal(convert.key_to_reference(keys)[same], rkeys[same])
    # k is clipped to the capacity
    assert bs_ops.beam_score(torch.from_numpy(x).to(cast),
                             *(torch.from_numpy(a) for a in (nbrs, u, q)), k=99,
                             metric=metric)[0].shape == (20, 12)
    # integer-valued (exact in bf16): every l2/ip sum is exact in any order
    xi = rng.integers(-8, 9, (50, 16)).astype(np.float32)
    qi = rng.integers(-8, 9, (20, 16)).astype(np.float32)
    (rids, rd, rkeys), (ids, d, keys) = both(xi, nbrs, u, qi, 12)
    np.testing.assert_array_equal(ids.numpy(), rids)
    if metric != "cos":
        np.testing.assert_array_equal(d.numpy(), rd)
        np.testing.assert_array_equal(convert.key_to_reference(keys), rkeys)
    else:
        np.testing.assert_allclose(d.numpy(), rd, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def int_index():
    """Reference-built graph over an integer corpus, plus its entry points."""
    rng = np.random.default_rng(2)
    x = rng.integers(-8, 9, (600, 16)).astype(np.float32)
    q = rng.integers(-8, 9, (70, 16)).astype(np.float32)
    out = {}
    for metric in ("l2", "ip", "cos"):
        cfg = RRD.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128,
                                   metric=metric)
        g = RRD.build(jnp.asarray(x), cfg, jax.random.PRNGKey(1))
        eps = np.asarray(RS.default_entry_points(jnp.asarray(x), 3, metric))
        out[metric] = (g, eps)
    return x, q, out


@pytest.mark.parametrize("gram_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_dense_search_matches_reference_exactly(int_index, metric, gram_dtype):
    """Integer corpus (exact in bf16 too): ids, l2/ip distances and work
    counters bit for bit; cos distances (a division and two square roots
    a score) within 1e-6."""
    x, q, graphs = int_index
    g, eps = graphs[metric]
    eps_b = np.broadcast_to(eps[None], (q.shape[0], eps.shape[0]))
    kw = dict(l=16, k=12, max_iters=48, topk=5, metric=metric, visited="dense",
              gram_dtype=gram_dtype)
    rids, rdist, rstats = RS.search_tiled(jnp.asarray(x), g, jnp.asarray(q),
                                          jnp.asarray(eps_b), RS.SearchConfig(**kw),
                                          tile_b=32, with_stats=True)
    pcfg = S.SearchConfig(**kw)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    ids, dist, stats = S.search_tiled(torch.from_numpy(x), pg, torch.from_numpy(q),
                                      torch.from_numpy(eps_b.copy()), pcfg, tile_b=32,
                                      with_stats=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    if metric == "cos":
        np.testing.assert_allclose(dist.numpy(), np.asarray(rdist), rtol=0, atol=1e-6)
    else:
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


@pytest.mark.parametrize("visited", ["dense", "hashed"])
def test_retired_lanes_expand_minus_one(int_index, monkeypatch, visited):
    """Every beam step hands a retired lane (padded, invalid or finished) the
    frontier id -1, and a live lane an id in [0, n): retired lanes score
    nothing. Results of the live lanes equal an all-live search."""
    x, q, graphs = int_index
    g, eps = graphs["l2"]
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    cfg = S.SearchConfig(l=16, k=12, max_iters=48, topk=5, visited=visited)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    full, _ = S.search_tiled(xt, pg, qt, int(eps[0]), cfg, tile_b=32)
    seen = []
    orig = bs_ops.beam_score

    def spy(xx, nbrs, u, queries, *a, **kw):
        seen.append((queries.data_ptr(), u.clone()))
        return orig(xx, nbrs, u, queries, *a, **kw)
    monkeypatch.setattr(bs_ops, "beam_score", spy)
    lv = torch.arange(q.shape[0]) % 4 != 1
    part, _, st = S.search_tiled(xt, pg, qt, int(eps[0]), cfg, tile_b=32, lane_valid=lv,
                                 with_stats=True)
    torch.testing.assert_close(part[lv], full[lv], rtol=0, atol=0)
    # tiles in the order they ran; lanes 70..95 pad the last one
    tile_of = {p: i for i, p in enumerate(dict.fromkeys(p for p, _ in seen))}
    assert len(tile_of) == 3
    retired = torch.cat([~lv, torch.ones(3 * 32 - q.shape[0], dtype=torch.bool)]).view(3, 32)
    for p, u in seen:
        assert bool((u[retired[tile_of[p]]] == -1).all())
        assert bool(((u == -1) | ((u >= 0) & (u < x.shape[0]))).all())
    assert sum(int((u >= 0).sum()) for _, u in seen) == st["work"]


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


def _masks(n, q_top1):
    """Tombstone masks: random, every query's unmasked top-1 masked (so the
    runner-up must surface), all true (equal to no mask), none true."""
    rng = np.random.default_rng(9)
    top1 = np.ones(n, bool)
    top1[q_top1] = False
    return {"random": rng.random(n) < 0.7, "top1": top1, "all": np.ones(n, bool),
            "none": np.zeros(n, bool)}


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_valid_mask_search_matches_reference(int_index, metric):
    """Dense search with a tombstone mask, on the integer index: ids and
    distances bit for bit for every mask; an all-true mask equals no mask
    bit for bit, an all-false one returns (-1, +inf) everywhere, and no
    masked id ever surfaces."""
    x, q, graphs = int_index
    g, eps = graphs[metric]
    eps_b = np.broadcast_to(eps[None], (q.shape[0], eps.shape[0])).copy()
    kw = dict(l=16, k=12, max_iters=48, topk=5, metric=metric, visited="dense")
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    xt, qt, et = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(eps_b)
    pcfg = S.SearchConfig(**kw)
    ids0, d0 = S.search_tiled(xt, pg, qt, et, pcfg, tile_b=32)
    for name, valid in _masks(x.shape[0], ids0[:, 0].numpy()).items():
        rids, rdist = RS.search_tiled(jnp.asarray(x), g, jnp.asarray(q), jnp.asarray(eps_b),
                                      RS.SearchConfig(**kw), tile_b=32,
                                      valid=jnp.asarray(valid))
        ids, dist = S.search_tiled(xt, pg, qt, et, pcfg, tile_b=32,
                                   valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(rids), err_msg=name)
        np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist), err_msg=name)
        got = ids.numpy()
        assert not np.isin(got[got >= 0], np.flatnonzero(~valid)).any()
        one, _ = S.search(xt, pg, qt, et, pcfg, valid=torch.from_numpy(valid))
        assert torch.equal(one, ids)
        if name == "all":
            assert torch.equal(ids, ids0) and torch.equal(dist, d0)
        if name == "none":
            assert (ids == -1).all() and torch.isinf(dist).all()
    with pytest.raises(ValueError, match="valid"):
        S.search_tiled(xt, pg, qt, et, pcfg, valid=torch.ones(5, dtype=torch.bool))


def test_default_entry_points_valid_mask(int_index):
    """Over a capacity-padded corpus (zero rows, which sit at the centroid)
    the masked centroid seed matches the reference and is live; masked
    random seeds are live and distinct (the port's generator, not JAX's);
    an all-true mask gives the unmasked seeds bit for bit; with fewer live
    rows than seeds the tail repeats the centroid seed."""
    x, _, _ = int_index
    n = x.shape[0]
    xp = np.concatenate([x, np.zeros((100, x.shape[1]), np.float32)])
    xt = torch.from_numpy(xp)
    valid = np.arange(n + 100) < n
    tomb = valid & (np.arange(n + 100) >= 10)
    for metric in ("l2", "ip", "cos"):
        for v in (valid, tomb):
            want = int(RS.default_entry_point(jnp.asarray(xp), metric, valid=jnp.asarray(v)))
            got = int(S.default_entry_point(xt, metric, valid=torch.from_numpy(v)))
            assert got == want and v[got]
    assert int(S.default_entry_point(xt)) >= n          # unmasked: a zero row wins
    ones = torch.ones(n + 100, dtype=torch.bool)
    assert int(S.default_entry_point(xt, valid=ones)) == int(S.default_entry_point(xt))
    for v in (valid, tomb):
        eps = S.default_entry_points(xt, 8, generator=torch.Generator().manual_seed(3),
                                     valid=torch.from_numpy(v)).numpy()
        assert eps.shape == (8,) and len(set(eps.tolist())) == 8 and v[eps].all()
    for e in (1, 5):
        a = S.default_entry_points(xt, e, generator=torch.Generator().manual_seed(4))
        b = S.default_entry_points(xt, e, generator=torch.Generator().manual_seed(4), valid=ones)
        assert torch.equal(a, b)
    tiny = np.zeros(n + 100, bool)
    tiny[[7, 12]] = True
    eps3 = S.default_entry_points(xt, 4, valid=torch.from_numpy(tiny)).numpy()
    assert set(eps3.tolist()) == {7, 12}
