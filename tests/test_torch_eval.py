"""Port parity: pairwise L2, brute-force ground truth and the evaluation
metrics against the reference (JAX, CPU, ``use_pallas=False`` branch).

l2 and ip ground truth run on integer corpora, where every distance is exact
and ties are frequent, so ids must match exactly (ties toward the lower
index on both sides). cos normalises; on a Gaussian corpus its top-k gaps are
far wider than f32 rounding, so its ids must match too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as RE
from repro.core import graph as RG
from repro.core import rnn_descent as RRD
from repro.kernels.pairwise_l2.ref import pairwise_l2_ref as jax_pairwise_l2_ref
from repro_torch import convert
from repro_torch.core import distances as D
from repro_torch.core import eval as E
from repro_torch.kernels.pairwise_l2 import ops as pl2
from repro_torch.kernels.pairwise_l2.ref import pairwise_l2_ref

torch.set_num_threads(1)


def _ints(seed, shape):
    return np.random.default_rng(seed).integers(-8, 9, shape).astype(np.float32)


def test_pairwise_l2_plain_matches_reference_exactly():
    a, b = _ints(0, (37, 20)), _ints(1, (53, 20))
    out = pl2.pairwise_l2(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), pairwise_l2_ref(torch.from_numpy(a),
                                                               torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_pairwise_l2_ref(
        jnp.asarray(a), jnp.asarray(b))))
    # bf16 input accumulates in f32 (integers in [-8, 8] are exact in bf16)
    out16 = pl2.pairwise_l2(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert out16.dtype == torch.float32
    np.testing.assert_array_equal(out16.numpy(), out.numpy())
    with pytest.raises(ValueError):
        pl2.pairwise_l2(torch.from_numpy(a), torch.from_numpy(b).double())
    with pytest.raises(ValueError):
        pl2.pairwise_l2(torch.from_numpy(a), torch.from_numpy(b[:, :5]))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_distances_match_reference(metric):
    """Integer data: l2/ip exact; cos normalises, held to 1e-6 (f32)."""
    from repro.core import distances as RDist
    a, b = _ints(8, (19, 12)), _ints(9, (33, 12))
    u = np.array([0, 3, -1, 7, 32], np.int32)
    v = np.array([5, -1, 2, 7, 0], np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (D.pairwise(ta, tb, metric), RDist.pairwise(jnp.asarray(a), jnp.asarray(b), metric)),
        (D.point_to_points(ta[4], tb, metric),
         RDist.point_to_points(jnp.asarray(a[4]), jnp.asarray(b), metric)),
        (D.batched_gram(tb.view(3, 11, 12), metric),
         RDist.batched_gram(jnp.asarray(b).reshape(3, 11, 12), metric)),
        (D.gather_dists(tb, torch.from_numpy(u), torch.from_numpy(v), metric),
         RDist.gather_dists(jnp.asarray(b), jnp.asarray(u), jnp.asarray(v), metric)),
        (D.pairwise_tiled(ta, tb, metric, tile_a=8),
         RDist.pairwise_tiled(jnp.asarray(a), jnp.asarray(b), metric, tile_a=8)),
    ]
    td, ti = D.pairwise_tiled(ta, tb, metric, tile_a=8, k=6)
    rdd, rii = RDist.pairwise_tiled(jnp.asarray(a), jnp.asarray(b), metric, tile_a=8, k=6)
    pairs.append((td, rdd))
    if metric != "cos":   # cos ties can order differently after rounding
        np.testing.assert_array_equal(ti.numpy(), np.asarray(rii))
    for out, ref in pairs:
        if metric == "cos":
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_ground_truth_matches_reference(metric):
    if metric == "cos":
        rng = np.random.default_rng(2)
        x = rng.standard_normal((700, 12)).astype(np.float32)
        q = rng.standard_normal((45, 12)).astype(np.float32)
    else:
        x, q = _ints(3, (700, 12)), _ints(4, (45, 12))
    rd_, ri = RE.ground_truth(jnp.asarray(x), jnp.asarray(q), k=10, metric=metric,
                              tile=16)
    d, i = E.ground_truth(torch.from_numpy(x), torch.from_numpy(q), k=10, metric=metric,
                          tile=16)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    if metric == "cos":
        np.testing.assert_allclose(d.numpy(), np.asarray(rd_), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd_))


def test_topk_smallest_breaks_ties_toward_lower_index():
    d = torch.tensor([[3., 1., 1., 0., 1., 1.], [2., 2., 2., 2., 2., 2.],
                      [float("inf"), 5., float("inf"), 5., 1., 0.]])
    vals, idx = D.topk_smallest(d, 3)
    ref_neg, ref_idx = jax.lax.top_k(-jnp.asarray(d.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(ref_neg))


@pytest.fixture(scope="module")
def ref_graph():
    x = _ints(5, (400, 16))
    cfg = RRD.RNNDescentConfig(s=8, r=12, t1=2, t2=2, capacity=16, chunk=128)
    return x, RRD.build(jnp.asarray(x), cfg, jax.random.PRNGKey(0))


def test_recall_and_graph_metrics_match_reference(ref_graph):
    x, g = ref_graph
    rng = np.random.default_rng(6)
    gt = rng.integers(0, 400, (30, 10)).astype(np.int32)
    pred = np.where(rng.random((30, 10)) < 0.6, gt, rng.integers(0, 400, (30, 10))).astype(np.int32)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    assert E.recall_at_k(tp, tg) == pytest.approx(RE.recall_at_k(jnp.asarray(pred), jnp.asarray(gt)), abs=1e-6)
    assert E.recall_topk(tp, tg) == pytest.approx(RE.recall_topk(jnp.asarray(pred), jnp.asarray(gt)), abs=1e-6)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    assert E.degree_stats(pg) == RE.degree_stats(g)
    # the port divides the reach count exactly; the reference's f32 mean
    # rounds, hence the few-ulp tolerance on fractions
    for entry in (0, 17):
        for iters in (3, 64):
            assert E.connectivity_lower_bound(pg, entry, iters=iters) == pytest.approx(
                RE.connectivity_lower_bound(g, entry, iters=iters), abs=1e-6)
    # an isolated vertex reaches only itself
    iso = RG.Graph(jnp.full((5, 2), -1, jnp.int32), jnp.full((5, 2), jnp.inf),
                   jnp.zeros((5, 2), jnp.uint8))
    piso = convert.graph_from_numpy(*(np.asarray(a) for a in iso), device="cpu")
    assert E.connectivity_lower_bound(piso, 2) == 0.2
    assert RE.connectivity_lower_bound(iso, 2) == pytest.approx(0.2, abs=1e-6)


def test_evaluate_search_reports_recall(ref_graph):
    x, g = ref_graph
    from repro_torch.core import search as S
    q = _ints(7, (20, 16))
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    _, gt = E.ground_truth(xt, qt, k=5)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    cfg = S.SearchConfig(l=32, k=16, max_iters=64, topk=5)
    out = E.evaluate_search(xt, pg, qt, gt, cfg, tile_b=8, repeats=1)
    ids, _ = S.search_tiled(xt, pg, qt, S.default_entry_point(xt), cfg, tile_b=8)
    assert out["recall_topk"] == E.recall_topk(ids, gt)
    assert out["search_path"] == "plain" and out["qps"] > 0
    assert out["visited_bytes_per_tile"] == S.visited_state_bytes(cfg, 400, 8)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ground_truth_valid_mask_matches_reference(metric):
    """A random tombstone mask, an all-true mask (equal to no mask) and a
    mask with fewer than k valid rows (the tail pads with (+inf, -1)), on an
    integer corpus: ids and distances bit for bit."""
    x, q = _ints(11, (300, 12)), _ints(12, (37, 12))
    rng = np.random.default_rng(13)
    few = np.zeros(300, bool)
    few[[4, 90, 200]] = True
    masks = {"random": rng.random(300) < 0.6, "all": np.ones(300, bool), "few": few}
    for name, valid in masks.items():
        rd_, ri = RE.ground_truth(jnp.asarray(x), jnp.asarray(q), k=10, metric=metric,
                                  tile=16, valid=jnp.asarray(valid))
        d, i = E.ground_truth(torch.from_numpy(x), torch.from_numpy(q), k=10, metric=metric,
                              tile=16, valid=torch.from_numpy(valid))
        assert i.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri), err_msg=name)
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd_), err_msg=name)
    assert (i[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()
    d0, i0 = E.ground_truth(torch.from_numpy(x), torch.from_numpy(q), k=10, metric=metric,
                            tile=16)
    d1, i1 = E.ground_truth(torch.from_numpy(x), torch.from_numpy(q), k=10, metric=metric,
                            tile=16, valid=torch.ones(300, dtype=torch.bool))
    assert torch.equal(i0, i1) and torch.equal(d0, d1)


def test_recall_topk_valid_mask_matches_reference():
    """The reference's masked semantics (a masked gt column leaves the
    denominator, a masked prediction never hits, a query with no valid gt
    column drops out), its unit case, and an all-true mask."""
    valid = np.array([True, True, False, True])
    gt = np.array([[0, 2, 3]], np.int32)
    for pred, want in (([[0, 3, 1]], 1.0), ([[0, 2, 2]], 0.5)):
        p = np.array(pred, np.int32)
        assert E.recall_topk(torch.from_numpy(p), torch.from_numpy(gt),
                             valid=torch.from_numpy(valid)) == want
        assert RE.recall_topk(jnp.asarray(p), jnp.asarray(gt), valid=jnp.asarray(valid)) == want
    rng = np.random.default_rng(14)
    gt = rng.integers(-1, 200, (40, 10)).astype(np.int32)
    pred = np.where(rng.random((40, 10)) < 0.5, gt, rng.integers(-1, 200, (40, 10))).astype(np.int32)
    valid = rng.random(200) < 0.7
    valid_none = np.zeros(200, bool)
    for v in (valid, np.ones(200, bool), valid_none):
        want = RE.recall_topk(jnp.asarray(pred), jnp.asarray(gt), valid=jnp.asarray(v))
        got = E.recall_topk(torch.from_numpy(pred), torch.from_numpy(gt), valid=torch.from_numpy(v))
        assert got == pytest.approx(want, abs=1e-6)


def test_evaluate_search_valid_mask(ref_graph):
    """evaluate_search(valid=) seeds from live rows, masks the results and
    scores them with the masked recall, as the reference does: the same
    recall on the reference's graph (dense visited, so exact)."""
    x, g = ref_graph
    from repro.core import search as RS
    from repro_torch.core import search as S
    q = _ints(15, (20, 16))
    valid = np.random.default_rng(16).random(400) < 0.7
    xt, qt, vt = torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(valid)
    _, gt = E.ground_truth(xt, qt, k=5, valid=vt)
    _, rgt = RE.ground_truth(jnp.asarray(x), jnp.asarray(q), k=5, valid=jnp.asarray(valid))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rgt))
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    kw = dict(l=32, k=16, max_iters=64, topk=5, visited="dense")
    out = E.evaluate_search(xt, pg, qt, gt, S.SearchConfig(**kw), tile_b=8, repeats=1,
                            valid=vt)
    ref = RE.evaluate_search(jnp.asarray(x), g, jnp.asarray(q), rgt, RS.SearchConfig(**kw),
                             tile_b=8, repeats=1, valid=jnp.asarray(valid))
    assert out["recall_topk"] == pytest.approx(ref["recall_topk"], abs=1e-6)
    assert out["recall_at_1"] == pytest.approx(ref["recall_at_1"], abs=1e-6)
