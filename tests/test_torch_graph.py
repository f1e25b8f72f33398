"""Port parity: repro_torch.core.graph against repro.core.graph.

The same numpy inputs go through the reference (JAX, CPU) and the port
(PyTorch, CPU). Every merge only moves ids, distances and flags, so every
comparison here is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as RD
from repro.core import graph as RG
from repro_torch import convert
from repro_torch.core import graph as G

torch.set_num_threads(1)

METRICS = ("l2", "ip", "cos")


def _port(g):
    return convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")


def _assert_graph_equal(port_g, ref_g):
    for a, b in zip(convert.graph_to_numpy(port_g), ref_g):
        np.testing.assert_array_equal(a, np.asarray(b))


def _ref_graph(seed, n, m, metric, d=16):
    """A valid reference graph with real distances and a NEW/OLD flag mix
    (as tests/test_bucketed_merge.py builds it)."""
    k = jax.random.PRNGKey(seed)
    kx, k1, k2 = jax.random.split(k, 3)
    x = jax.random.normal(kx, (n, d))
    ids = jax.random.randint(k1, (n, m), -2, n, dtype=jnp.int32)
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    ids = jnp.where(ids == rows, -1, ids)
    ids = RG.dedup_row_ids(jnp.where(ids < 0, -1, ids))
    dist = RD.gather_dists(x, jnp.broadcast_to(rows, ids.shape).reshape(-1),
                           ids.reshape(-1), metric).reshape(n, m)
    flags = jax.random.randint(k2, (n, m), 0, 2).astype(jnp.uint8)
    g = RG.sort_rows(RG.Graph(ids, jnp.where(ids >= 0, dist, jnp.inf),
                              jnp.where(ids >= 0, flags, RG.OLD)))
    return x, g


def _cands(seed, x, n, n_cand, metric):
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, n, n_cand).astype(np.int32)
    dst = rng.integers(-1, n, n_cand).astype(np.int32)
    dist = np.array(RD.gather_dists(x, jnp.asarray(src), jnp.asarray(dst), metric))
    return src, dst, dist


def test_dist_key_matches_reference_exactly():
    rng = np.random.default_rng(0)
    special = np.array([-np.inf, -3.4e38, -2.5, -1.0, -1e-20, -1e-45, -0.0, 0.0,
                        1e-45, 1e-20, 1e-3, 1.0, 2.5, 1e10, 3.4e38, np.inf], np.float32)
    vals = np.concatenate([special, rng.standard_normal(2000).astype(np.float32) * 1e3])
    ref = np.asarray(RG.dist_key(jnp.asarray(vals)))
    key = G.dist_key(torch.from_numpy(vals))
    np.testing.assert_array_equal(convert.key_to_reference(key), ref)
    np.testing.assert_array_equal(convert.key_from_reference(ref).numpy(), key.numpy())
    # inverse is exact (bits, so -0.0 stays -0.0) and the order is preserved
    back = G.key_dist(key).numpy()
    np.testing.assert_array_equal(back.view(np.int32), vals.view(np.int32))
    order = np.argsort(vals, kind="stable")
    assert (np.diff(key.numpy()[order].astype(np.int64)) >= 0).all()
    # -0.0 sorts below +0.0 in both keys; the reference's empty-slot sentinel
    # 0xFFFFFFFF is INT32_MAX
    assert key.numpy()[6] < key.numpy()[7] and ref[6] < ref[7]
    assert convert.key_to_reference(np.array([G.KEY_SENTINEL]))[0] == 0xFFFFFFFF


def test_sort_rows_matches_reference_with_ties():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 50, (40, 12)).astype(np.int32)
    dists = rng.integers(0, 4, (40, 12)).astype(np.float32)   # many ties
    dists[ids < 0] = np.inf
    flags = rng.integers(0, 2, (40, 12)).astype(np.uint8)
    ref = RG.sort_rows(RG.Graph(jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(flags)))
    out = G.sort_rows(convert.graph_from_numpy(ids, dists, flags, device="cpu"))
    _assert_graph_equal(out, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_random_init_graph_semantics(metric):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(300, 8, generator=gen)
    g = G.random_init_graph(x, 10, 16, metric, gen)
    nb, d, f = g.neighbors.numpy(), g.dists.numpy(), g.flags.numpy()
    for i in range(nb.shape[0]):
        valid = nb[i] >= 0
        k = valid.sum()
        assert 1 <= k <= 10 and valid[:k].all()
        assert i not in nb[i, :k], "self loop"
        assert len(set(nb[i, :k].tolist())) == k, "duplicate neighbour"
        assert (np.diff(d[i, :k]) >= 0).all() and np.isinf(d[i, k:]).all()
        assert (f[i, :k] == G.NEW).all()
        want = G.D.gather_dists(x, torch.full((k,), i), torch.from_numpy(nb[i, :k]), metric)
        np.testing.assert_array_equal(d[i, :k], want.numpy())


@pytest.mark.parametrize("with_prio", [False, True])
@pytest.mark.parametrize("n_buckets", [8, 64])
def test_bucket_scatter_tables_match_reference(with_prio, n_buckets):
    n = 40
    x, _ = _ref_graph(4, n, 4, "ip")
    src, dst, dist = _cands(5, x, n, 600, "ip")
    flag = np.random.default_rng(6).integers(0, 2, 600).astype(np.uint8)
    prio = np.random.default_rng(7).integers(0, 2, 600).astype(np.int32) if with_prio else None
    ref = RG.bucket_scatter_tables(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(dist), jnp.asarray(flag), n,
        n_buckets, prio=None if prio is None else jnp.asarray(prio))
    out = G.bucket_scatter_tables(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(dist),
        torch.from_numpy(flag), n, n_buckets,
        prio=None if prio is None else torch.from_numpy(prio))
    if with_prio:
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    else:
        assert out[0] is None and ref[0] is None
    np.testing.assert_array_equal(convert.key_to_reference(out[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", METRICS)
def test_merge_candidate_edges_matches_reference(merge, metric):
    n, m = 48, 6
    x, g = _ref_graph(10, n, m, metric)
    src, dst, dist = _cands(11, x, n, 150, metric)
    ref = RG.merge_candidate_edges(g, jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(dist), merge=merge, n_buckets=16)
    out = G.merge_candidate_edges(_port(g), torch.from_numpy(src), torch.from_numpy(dst),
                                  torch.from_numpy(dist), merge=merge, n_buckets=16)
    _assert_graph_equal(out, ref)


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", METRICS)
def test_add_reverse_edges_matches_reference(merge, metric):
    n, m = 48, 8
    _, g = _ref_graph(12, n, m, metric)
    ref = RG.add_reverse_edges(g, 5, merge=merge, n_buckets=16)
    out = G.add_reverse_edges(_port(g), 5, merge=merge, n_buckets=16)
    _assert_graph_equal(out, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_bucketed_equals_sort_with_injective_buckets(metric):
    """With n_buckets >= next_pow2(n) the slot hash is injective, so the
    bucketed merges reproduce the sort oracle exactly (the reference's
    tests/test_bucketed_merge.py property, on the port)."""
    n, m = 48, 6
    x, g = _ref_graph(20, n, m, metric)
    src, dst, dist = _cands(21, x, n, 200, metric)
    pg = _port(g)
    args = (torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(dist))
    a = G.merge_candidate_edges(pg, *args, merge="sort")
    b = G.merge_candidate_edges(pg, *args, merge="bucketed", n_buckets=64)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    a = G.add_reverse_edges(pg, 4, merge="sort")
    b = G.add_reverse_edges(pg, 4, merge="bucketed", n_buckets=64)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_degrees_match_reference():
    _, g = _ref_graph(30, 60, 7, "l2")
    pg = _port(g)
    np.testing.assert_array_equal(G.out_degrees(pg).numpy(), np.asarray(RG.out_degrees(g)))
    np.testing.assert_array_equal(G.in_degrees(pg).numpy(), np.asarray(RG.in_degrees(g)))
    # f32 means summed in another order: equal to a few ulp
    assert float(G.average_out_degree(pg, k=3)) == pytest.approx(
        float(RG.average_out_degree(g, k=3)), rel=1e-6)


def test_merge_rejects_unknown_mode_and_bad_buckets():
    _, g = _ref_graph(31, 10, 4, "l2")
    pg = _port(g)
    e = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="merge mode"):
        G.merge_candidate_edges(pg, e, e, e.float(), merge="heap")
    with pytest.raises(ValueError, match="merge mode"):
        G.add_reverse_edges(pg, 2, merge="heap")
    with pytest.raises(ValueError, match="power of two"):
        G.merge_candidate_edges(pg, e, e, e.float(), merge="bucketed", n_buckets=12)
