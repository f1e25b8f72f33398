"""Port parity: NN-Descent (``core/nn_descent.py``) and the bucket-table fold
(``graph.combine_bucket_tables(_pair)``) against the reference (JAX, CPU).

Corpora are integer-valued (numpy integers in [-8, 8], d = 24): every l2 and
ip distance is exact in f32 whatever the summation order, so graphs, flat
candidate lists and bucket tables are compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.core import nn_descent as RN
from repro.quant import Quantization as RQuantization
from repro_torch import convert
from repro_torch.core import graph as G
from repro_torch.core import nn_descent as nnd
from repro_torch.quant import Quantization, prep_corpus

torch.set_num_threads(1)


def _int_corpus(seed, n=1500, d=24):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def _cfgs(**kw):
    return RN.NNDescentConfig(**kw), nnd.NNDescentConfig(**kw)


def _port(g):
    return convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")


def _unpack(table):
    """A packed join table -> the staged tables ``(k, i, f)`` of
    ``graph.bucket_scatter_tables`` (no priority stage; empty slots
    ``(KEY_SENTINEL, INT32_MAX, 0)``, filled ones flagged NEW)."""
    empty = table == nnd.INT64_MAX
    return (torch.where(empty, G.KEY_SENTINEL, (table >> 32).int()),
            torch.where(empty, G.INT32_MAX, (table & 0xFFFFFFFF).int()),
            (~empty).to(torch.uint8) * G.NEW)


def _assert_graph_equal(out, ref):
    for a, b in zip(convert.graph_to_numpy(out), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_config_validation_matches_reference():
    for kw in ({"merge": "heap"}, {"quant": "int8"}):
        with pytest.raises(ValueError):
            RN.NNDescentConfig(**kw)
        with pytest.raises(ValueError):
            nnd.NNDescentConfig(**kw)
    assert nnd.NNDescentConfig() == nnd.NNDescentConfig(k=64, s=10, iters=10, merge="bucketed")
    ref, port = RN.NNDescentConfig(), nnd.NNDescentConfig()
    for f in ("k", "s", "iters", "sample", "metric", "chunk", "merge", "n_buckets"):
        assert getattr(ref, f) == getattr(port, f)


@pytest.fixture(scope="module")
def ref_graphs():
    """Reference graphs on one integer corpus: the random initial graph and
    the graph after one join_and_update, per (metric, merge)."""
    x = _int_corpus(0)
    out = {}
    for metric in ("l2", "ip"):
        for merge in ("sort", "bucketed"):
            cfg, _ = _cfgs(k=16, s=8, iters=4, metric=metric, merge=merge, chunk=64)
            g0 = RN.random_init(jax.random.PRNGKey(1), jnp.asarray(x), cfg)
            out[metric, merge] = (g0, RN.join_and_update(jnp.asarray(x), g0, cfg))
    return x, out


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("chunk", [64, 1000])
def test_join_candidates_matches_reference(ref_graphs, metric, chunk):
    """The flat (src, dst, dist) lists, chunk padding included (1500 rows
    are no multiple of either chunk)."""
    x, graphs = ref_graphs
    g = graphs[metric, "sort"][1]
    cfg, pcfg = _cfgs(k=16, metric=metric, chunk=chunk)
    ref = RN.join_candidates(jnp.asarray(x), g.neighbors, g.flags, cfg)
    pg = _port(g)
    out = nnd.join_candidates(torch.from_numpy(x), pg.neighbors, pg.flags, pcfg)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_join_and_update_matches_reference(ref_graphs, metric, merge):
    """One iteration on a graph the reference produced (its second
    iteration: rows full, NEW and OLD flags mixed)."""
    x, graphs = ref_graphs
    g = graphs[metric, merge][1]
    cfg, pcfg = _cfgs(k=16, s=8, iters=4, metric=metric, merge=merge, chunk=64)
    ref = RN.join_and_update(jnp.asarray(x), g, cfg)
    out = nnd.join_and_update(torch.from_numpy(x), _port(g), pcfg)
    _assert_graph_equal(out, ref)


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_whole_build_matches_reference(metric, merge):
    """K = 16, S = 8, 4 iterations from the reference's own random initial
    graph: the reference's built graph bit for bit (drift compounding over
    iterations would show here)."""
    x = _int_corpus(2)
    cfg, pcfg = _cfgs(k=16, s=8, iters=4, metric=metric, merge=merge)
    key = jax.random.PRNGKey(9)
    ref = RN.build(jnp.asarray(x), cfg, key)
    g = _port(RN.random_init(key, jnp.asarray(x), cfg))
    for _ in range(pcfg.iters):
        g = nnd.join_and_update(torch.from_numpy(x), g, pcfg)
    _assert_graph_equal(g, ref)


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
def test_sampled_join_matches_reference(merge):
    """``sample`` caps the join width (the nearest 6 of each row's 16):
    three iterations from the reference's initial graph, bit for bit."""
    x = _int_corpus(3, n=800)
    cfg, pcfg = _cfgs(k=16, s=8, iters=3, sample=6, merge=merge)
    key = jax.random.PRNGKey(5)
    ref = RN.build(jnp.asarray(x), cfg, key)
    g = _port(RN.random_init(key, jnp.asarray(x), cfg))
    for _ in range(pcfg.iters):
        g = nnd.join_and_update(torch.from_numpy(x), g, pcfg)
    _assert_graph_equal(g, ref)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_chunked_join_merge_equals_one_scatter_and_the_fold(ref_graphs, metric, monkeypatch):
    """The join table accumulated over many small chunks equals (a) one
    staged scatter of the whole flat candidate list and (b) the per-chunk
    tables folded with combine_bucket_tables_pair; the iteration at a tiny
    budget equals the default one."""
    x, graphs = ref_graphs
    g = _port(graphs[metric, "bucketed"][1])
    xt = torch.from_numpy(x)
    _, pcfg = _cfgs(k=16, metric=metric)
    n, m = g.neighbors.shape
    nb = nnd.default_join_buckets(pcfg, m)
    whole_graph = nnd.join_and_update(xt, g, pcfg)
    budget = 4000                               # 15 rows of 256 candidates a chunk
    monkeypatch.setattr(nnd, "JOIN_BUDGET", budget)
    chunked = _unpack(nnd.join_table(xt, g.neighbors, g.flags, pcfg, nb))
    src, dst, dist = nnd.join_candidates(xt, g.neighbors, g.flags, pcfg)
    new = torch.full(dst.shape, G.NEW, dtype=torch.uint8)
    _, *whole = G.bucket_scatter_tables(src, dst, dist, new, n, nb)
    assert int((whole[0] != G.KEY_SENTINEL).sum()) > 0
    rows = budget // (m * m)
    acc = None
    for s in range(0, n, rows):
        part = nnd.join_candidates(xt, g.neighbors[s:s + rows], g.flags[s:s + rows], pcfg)
        tab = G.bucket_scatter_tables(part[0], part[1], part[2],
                                      torch.full(part[1].shape, G.NEW, dtype=torch.uint8),
                                      n, nb)
        acc = tab if acc is None else G.combine_bucket_tables_pair(acc, tab)
    assert s > 0                               # several chunks
    for a, b, c in zip(chunked, whole, acc[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    torch.testing.assert_close(tuple(nnd.join_and_update(xt, g, pcfg)), tuple(whole_graph),
                               rtol=0, atol=0)


def _random_tables(seed, parts, n=40, nb=16, prio=True):
    """Partial staged tables from random edge lists over one (n, nb) grid,
    with many ties in priority, distance and id."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(parts):
        e = 600
        rows = torch.from_numpy(rng.integers(-1, n + 1, e).astype(np.int32))
        ids = torch.from_numpy(rng.integers(-1, 3 * n, e).astype(np.int32))
        dist = torch.from_numpy(rng.integers(-3, 4, e).astype(np.float32))
        flag = torch.from_numpy(rng.integers(0, 2, e).astype(np.uint8))
        pr = torch.from_numpy(rng.integers(0, 2, e).astype(np.int32)) if prio else None
        out.append(G.bucket_scatter_tables(rows, ids, dist, flag, n, nb, prio=pr))
    return out


def _to_reference(tab):
    p, k, i, f = tab
    return (None if p is None else jnp.asarray(p.numpy()),
            jnp.asarray(convert.key_to_reference(k)), jnp.asarray(i.numpy()),
            jnp.asarray(f.numpy()))


def _assert_tables_equal(out, ref):
    p, k, i, f = out
    assert (p is None) == (ref[0] is None)
    if p is not None:
        np.testing.assert_array_equal(p.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(convert.key_to_reference(k), np.asarray(ref[1]))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(f.numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("prio", [True, False])
def test_combine_bucket_tables_match_reference(prio):
    """Stacked and pairwise folds of random partial tables, against the
    reference's folds of the same tables (keys converted exactly)."""
    parts = _random_tables(3, 4, prio=prio)
    stack = [None if t[0] is None else torch.stack(t) for t in zip(*parts)]
    ref_stack = [None if a[0] is None else jnp.stack(a)
                 for a in zip(*(_to_reference(t) for t in parts))]
    _assert_tables_equal(G.combine_bucket_tables(*stack), RG.combine_bucket_tables(*ref_stack))
    acc, ref_acc = parts[0], _to_reference(parts[0])
    for t in parts[1:]:
        acc = G.combine_bucket_tables_pair(acc, t)
        ref_acc = RG.combine_bucket_tables_pair(ref_acc, _to_reference(t))
    _assert_tables_equal(acc, ref_acc)
    for a, b in zip(acc[1:], G.combine_bucket_tables(*stack)[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_merge_rows_with_table_is_the_generic_row_merge():
    """The join's row merge (one-slot dedup, top-k of the packed key)
    against graph.merge_rows_with_buckets on rows of distinct ids with heavy
    distance ties, -0.0 beside +0.0, ids shared with the buckets, rows
    shorter than the cap, +inf distances and empty slots."""
    rng = np.random.default_rng(4)
    r, m, nb, n = 300, 12, 32, 200
    ids = np.full((r, m), -1, np.int32)
    dist = np.full((r, m), np.inf, np.float32)
    for i in range(r):
        v = rng.integers(0, m + 1)
        ids[i, :v] = rng.choice(n, v, replace=False)
        dist[i, :v] = np.sort(rng.integers(0, 4, v)).astype(np.float32)
    dist[(dist == 0) & (rng.random((r, m)) < 0.5)] = -0.0
    assert np.signbit(dist[dist == 0]).any()
    g = G.Graph(torch.from_numpy(ids), torch.from_numpy(dist),
                torch.from_numpy(rng.integers(0, 2, (r, m)).astype(np.uint8)))
    e = 20_000
    rows = torch.from_numpy(rng.integers(0, r, e).astype(np.int32))
    cand = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    cd = torch.from_numpy(rng.integers(0, 4, e).astype(np.float32))
    cd[::7] = -0.0
    cd[::11] = float("inf")
    new = torch.full((e,), G.NEW, dtype=torch.uint8)
    b_ids, b_dist, b_flag = G.bucket_scatter(rows, cand, cd, new, r, nb)
    _, k_tab, i_tab, _ = G.bucket_scatter_tables(rows, cand, cd, new, r, nb)
    table = torch.where(k_tab == G.KEY_SENTINEL, nnd.INT64_MAX,
                        (k_tab.long() << 32) | i_tab.long())
    for cap in (m, 7):
        want = G.merge_rows_with_buckets(g, b_ids, b_dist, b_flag, cap, m)
        out = nnd.merge_rows_with_table(g, table, cap)
        for a, b in zip(out, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_coded_build_runs_over_x_hat():
    """quant=int8 descends over the decoded corpus: the same graph as an
    f32 build over prep_corpus's x_hat from the same generator."""
    x = torch.from_numpy(_int_corpus(5, n=600))
    quant = Quantization(mode="int8")
    cfg = nnd.NNDescentConfig(k=12, s=6, iters=3, quant=quant)
    g = nnd.build(x, cfg, torch.Generator().manual_seed(3))
    x_hat, _ = prep_corpus(x, quant)
    want = nnd.build(x_hat, nnd.NNDescentConfig(k=12, s=6, iters=3),
                     torch.Generator().manual_seed(3))
    assert not torch.equal(x_hat, x)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert RN.NNDescentConfig(quant=RQuantization(mode="int8")).quant.is_coded


def test_build_from_numpy_on_the_cpu():
    """numpy input is placed on ``device``; the default generator seeds 0;
    rows are valid-first and sorted, without self loops or repeated ids."""
    x = _int_corpus(6, n=500)
    g = nnd.build(x, nnd.NNDescentConfig(k=10, s=5, iters=3), device="cpu")
    again = nnd.build(torch.from_numpy(x), nnd.NNDescentConfig(k=10, s=5, iters=3),
                      torch.Generator().manual_seed(0))
    for a, b in zip(g, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ids, valid = g.neighbors, g.neighbors >= 0
    assert ids.shape == (500, 10) and float(valid.float().mean()) > 0.9
    assert bool((valid[:, :-1] | ~valid[:, 1:]).all())
    assert not bool((ids == torch.arange(500, dtype=torch.int32)[:, None]).any())
    s = torch.sort(ids, dim=1).values
    assert bool(((s.diff(dim=1) != 0) | (s[:, 1:] < 0)).all())
    assert bool((g.dists.diff(dim=1)[valid[:, 1:]] >= 0).all())
