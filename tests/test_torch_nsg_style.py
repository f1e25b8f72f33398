"""Port parity: the NSG-style baseline (``core/nsg_style.py``) against the
reference (JAX, CPU), and the RNG prune at NSG's candidate width C = 132.

Corpora are integer-valued (numpy integers in [-8, 8], d = 24, or integer
clusters far apart): every l2 and ip distance is exact in f32, so candidate
pools, keep masks and graphs are compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.core import nn_descent as RN
from repro.core import nsg_style as RS
from repro.core.rng import rng_prune_rows as ref_prune_rows
from repro.core.search import default_entry_point as ref_entry
from repro.quant import Quantization as RQuantization
from repro_torch import convert
from repro_torch.core import eval as E
from repro_torch.core import nn_descent as nnd
from repro_torch.core import nsg_style as nsg
from repro_torch.core.rng import rng_prune_rows
from repro_torch.core.search import default_entry_point
from repro_torch.quant import Quantization, prep_corpus

torch.set_num_threads(1)


def _int_corpus(seed, n=1500, d=24):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def _port(g):
    return convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")


def _assert_graph_equal(out, ref):
    for a, b in zip(convert.graph_to_numpy(out), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def _cfgs(metric, r=12, c=40, k=16):
    knn = dict(k=k, s=8, iters=4, metric=metric)
    return (RS.NSGStyleConfig(r=r, c=c, knn=RN.NNDescentConfig(**knn), metric=metric),
            nsg.NSGStyleConfig(r=r, c=c, knn=nnd.NNDescentConfig(**knn), metric=metric))


@pytest.fixture(scope="module")
def knn_graphs():
    """The reference's NN-Descent graph (K = 16) on one integer corpus, l2
    and ip."""
    x = _int_corpus(0)
    out = {}
    for metric in ("l2", "ip"):
        cfg, _ = _cfgs(metric)
        out[metric] = RN.build(jnp.asarray(x), cfg.knn, jax.random.PRNGKey(2))
    return x, out


def test_config_validation_matches_reference():
    for kw in ({"merge": "heap"}, {"quant": "pq"}):
        with pytest.raises(ValueError):
            RS.NSGStyleConfig(**kw)
        with pytest.raises(ValueError):
            nsg.NSGStyleConfig(**kw)
    with pytest.raises(ValueError, match="knn.quant"):
        RS.NSGStyleConfig(quant=RQuantization(mode="int8"),
                          knn=RN.NNDescentConfig(quant=RQuantization(mode="int8")))
    with pytest.raises(ValueError, match="knn.quant"):
        nsg.NSGStyleConfig(quant=Quantization(mode="int8"),
                           knn=nnd.NNDescentConfig(quant=Quantization(mode="int8")))
    ref, port = RS.NSGStyleConfig(), nsg.NSGStyleConfig()
    for f in ("r", "c", "metric", "chunk", "merge", "n_buckets"):
        assert getattr(ref, f) == getattr(port, f)
    assert (port.r, port.c, port.knn.k) == (32, 132, 64)


@pytest.mark.parametrize("iters", [1, 3, 64])
def test_reachable_mask_matches_reference(knn_graphs, iters):
    x, graphs = knn_graphs
    g = graphs["l2"]
    ref = RS.reachable_mask(g, 7, iters)
    out = nsg.reachable_mask(_port(g), 7, iters)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("rows", [None, "subset"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_expand_candidates_matches_reference(knn_graphs, metric, rows):
    """Pools of k + k² ids deduplicated, the nearest C kept (ties toward the
    lower id); with ``rows=`` a block of vertex ids with -1 holes. The
    port's chunk (37 rows) is no divisor of the reference's (256)."""
    x, graphs = knn_graphs
    g = graphs[metric]
    blk = None if rows is None else np.array([5, -1, 0, 1499, 77, -1, 5, 300], np.int32)
    ref = RS.expand_candidates(jnp.asarray(x), g, 40, metric,
                               rows=None if blk is None else jnp.asarray(blk))
    out = nsg.expand_candidates(torch.from_numpy(x), _port(g), 40, metric, chunk=37,
                                rows=None if blk is None else torch.from_numpy(blk))
    assert int((out[0] >= 0).sum()) > 0
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if rows is None:
        for a, b in zip(out, nsg.expand_candidates(torch.from_numpy(x), _port(g), 40, metric)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rng_cap_rows_matches_reference(knn_graphs, metric):
    x, graphs = knn_graphs
    cfg, pcfg = _cfgs(metric)
    cand = RS.expand_candidates(jnp.asarray(x), graphs[metric], cfg.c, metric)
    ref = RS.rng_cap_rows(jnp.asarray(x), *cand, cfg)
    out = nsg.rng_cap_rows(torch.from_numpy(x),
                           *(torch.from_numpy(np.array(a)) for a in cand), pcfg)
    _assert_graph_equal(out, ref)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rng_prune_rows_at_nsg_width_matches_reference(metric):
    """The prune at C = 132 (the rows the card's rng_prune takes through its
    M <= 256 instance): distance-sorted candidate rows, -1 padded."""
    x = _int_corpus(3, n=800)
    g = RN.build(jnp.asarray(x), RN.NNDescentConfig(k=24, s=8, iters=3, metric=metric),
                 jax.random.PRNGKey(4))
    ids, dists = RS.expand_candidates(jnp.asarray(x), g, 132, metric)
    assert ids.shape[1] == 132 and int((np.asarray(ids)[:, -1] >= 0).sum()) > 0
    ref = ref_prune_rows(jnp.asarray(x), ids, dists, metric, chunk=64)
    out = rng_prune_rows(torch.from_numpy(x), torch.from_numpy(np.array(ids)),
                         torch.from_numpy(np.array(dists)), metric, chunk=100)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pipeline_from_the_reference_knn_graph_matches(knn_graphs, metric):
    """expand -> prune and cap -> reverse edges (bucketed) -> repair (sort),
    from the reference's K-NN graph: the reference's NSG graph bit for bit."""
    x, graphs = knn_graphs
    cfg, pcfg = _cfgs(metric)
    xj = jnp.asarray(x)
    cand = RS.expand_candidates(xj, graphs[metric], cfg.c, metric)
    capped = RS.rng_cap_rows(xj, *cand, cfg)
    g = RG.add_reverse_edges(capped, cfg.r, merge=cfg.merge)
    ref = RS.ensure_reachable(xj, g, ref_entry(xj, metric), metric)
    out = nsg.refine(torch.from_numpy(x), _port(graphs[metric]), pcfg)
    _assert_graph_equal(out, ref)
    assert int(default_entry_point(torch.from_numpy(x), metric)) == int(ref_entry(xj, metric))


def _islands(seed, clusters=10, per=50, d=16):
    """Integer points in far-apart clusters: a K-NN graph splits into
    islands, one a cluster."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-4, 5, (clusters, d)) * 200
    x = centers[np.repeat(np.arange(clusters), per)] + rng.integers(-3, 4, (clusters * per, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ensure_reachable_connects_disconnected_clusters(metric):
    """On the port's own graph over disconnected clusters (NN-Descent, then
    expand, prune to R = 8 of C = 96 and reverse edges: whole clusters
    unreachable from the entry), the repair equals the reference's repair of
    the same graph. Under l2 it leaves every vertex reachable: an island's
    repair edges all come from the one reachable vertex nearest it, and a
    row has room for C - R = 88 of them, more than an island's 50 vertices.
    Under ip every vertex's "nearest" is the same few vertices of largest
    inner product, whose rows overflow: it adds reach, and every repair
    edge it drops was pushed out of a full row of nearer entries."""
    x = _islands(5)
    xt = torch.from_numpy(x)
    cfg = nsg.NSGStyleConfig(r=8, c=96, knn=nnd.NNDescentConfig(k=8, s=4, iters=4,
                                                                 metric=metric), metric=metric)
    kg = nnd.build(xt, cfg.knn, torch.Generator().manual_seed(1))
    capped = nsg.rng_cap_rows(xt, *nsg.expand_candidates(xt, kg, cfg.c, metric), cfg)
    g = nsg.G.add_reverse_edges(capped, cfg.r, merge=cfg.merge)
    ep = int(default_entry_point(xt, metric))
    n = x.shape[0]
    before = E.connectivity_lower_bound(g, ep, iters=n)
    assert before < 0.9
    out = nsg.ensure_reachable(xt, g, ep, metric)
    after = E.connectivity_lower_bound(out, ep, iters=n)
    assert after == 1.0 if metric == "l2" else after > before
    reach = nsg.reachable_mask(g, ep, 64)
    unreached = (~reach).nonzero().squeeze(1).int()
    src = nsg.repair_sources(xt, reach, metric)[unreached.long()]
    rows, dists = out.neighbors[src.long()], out.dists[src.long()]
    kept = (rows == unreached[:, None]).any(1)
    d = nsg.D.gather_dists(xt, src, unreached, metric)
    full = (rows >= 0).all(1) & (dists <= d[:, None]).all(1)
    assert bool((kept | full).all())
    assert bool(kept.all()) if metric == "l2" else not bool(kept.all())
    gj = RG.Graph(*(jnp.asarray(a) for a in convert.graph_to_numpy(g)))
    _assert_graph_equal(out, RS.ensure_reachable(jnp.asarray(x), gj, ep, metric))


def test_build_composes_nn_descent_and_refine():
    """build = nn_descent.build (same generator seed) then refine; the graph
    holds at most R + repair edges a row, no self loops."""
    x = torch.from_numpy(_int_corpus(6, n=700))
    _, pcfg = _cfgs("l2")
    g = nsg.build(x, pcfg, torch.Generator().manual_seed(3))
    want = nsg.refine(x, nnd.build(x, pcfg.knn, torch.Generator().manual_seed(3)), pcfg)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert g.neighbors.shape == (700, pcfg.c)
    assert not bool((g.neighbors == torch.arange(700, dtype=torch.int32)[:, None]).any())
    assert E.connectivity_lower_bound(g, int(default_entry_point(x)), iters=700) == 1.0


def test_coded_build_runs_over_x_hat():
    """quant=int8 on NSGStyleConfig decodes once and runs every stage over
    x_hat: the f32 build over prep_corpus's x_hat, from the same generator."""
    x = torch.from_numpy(_int_corpus(7, n=600))
    quant = Quantization(mode="int8")
    knn = nnd.NNDescentConfig(k=12, s=6, iters=3)
    g = nsg.build(x, nsg.NSGStyleConfig(r=10, c=30, knn=knn, quant=quant),
                  torch.Generator().manual_seed(2))
    x_hat, _ = prep_corpus(x, quant)
    want = nsg.build(x_hat, nsg.NSGStyleConfig(r=10, c=30, knn=knn),
                     torch.Generator().manual_seed(2))
    assert not torch.equal(x_hat, x)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
