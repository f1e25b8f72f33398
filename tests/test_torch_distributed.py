"""Port parity of the row-sharded builds (``core/shard.py``) on gloo CPU ranks
against the reference's single-device builds (JAX, CPU).

Two process groups, of 2 and 4 ranks, each run every build once
(``tests/_dist_workers.builds``; the children import torch and repro_torch
alone): RNN-Descent over f32 rows and over int8 codes, NN-Descent and
NSG-style, under l2 and ip, from the reference's own initial graphs, on an
integer corpus of N = 701 rows (divisible by none of 2, 4 and 8, so the
padding runs). Integer corpora and code spaces (int8 scale 1/2, zero 0) keep every
distance exact in f32, so graphs are compared bit for bit: ids, distances,
flags. The reference's sharded build on its 1-device mesh (which passes
under jax 0.9) is held to the same graphs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
from repro import quant as RQ
from repro.core import graph as RG
from repro.core import nn_descent as RN
from repro.core import nsg_style as RNS
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.core import shard as RSH
from repro_torch import convert
from repro_torch.core import nn_descent as nnd
from repro_torch.core import nsg_style as ns
from repro_torch.core import rnn_descent as rd
from repro_torch.core import shard

torch.set_num_threads(1)

N, DIM = 701, 16
RNN = dict(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128)
NND = dict(k=12, s=6, iters=3, chunk=64)
NSG = dict(r=12, c=24)
BUILDS = ["rnn_l2", "rnn_ip", "rnn_int8", "nnd_l2", "nnd_ip", "nsg_l2", "nsg_ip"]


def _port(g):
    return convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")


def _equal(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def reference():
    """The cases (port inputs for the ranks) and the reference's graphs."""
    rng = np.random.default_rng(20)
    x = rng.integers(-8, 9, (N, DIM)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    key = jax.random.PRNGKey(1)
    cases, ref = {}, {}
    for metric in ("l2", "ip"):
        cfg = RRD.RNNDescentConfig(**RNN, metric=metric)
        g0 = RRD.random_init(key, xj, cfg)
        cases[f"rnn_{metric}"] = ("rnn", xt, rd.RNNDescentConfig(**RNN, metric=metric),
                                  _port(g0), None, None)
        ref[f"rnn_{metric}"] = RRD.build(xj, cfg, key)
        cfg = RN.NNDescentConfig(**NND, metric=metric)
        g0 = RN.random_init(key, xj, cfg)
        cases[f"nnd_{metric}"] = ("nnd", xt, nnd.NNDescentConfig(**NND, metric=metric),
                                  _port(g0), None, None)
        ref[f"nnd_{metric}"] = RN.build(xj, cfg, key)
        cfg = RNS.NSGStyleConfig(**NSG, knn=RN.NNDescentConfig(**NND, metric=metric),
                                 metric=metric)
        entry = int(RS.default_entry_point(xj, metric))
        g0 = RN.random_init(key, xj, cfg.knn)
        cases[f"nsg_{metric}"] = ("nsg", xt, ns.NSGStyleConfig(
            **NSG, knn=nnd.NNDescentConfig(**NND, metric=metric), metric=metric),
            _port(g0), None, entry)
        ref[f"nsg_{metric}"] = RNS.build(xj, cfg, key, entry=entry)
    # int8: an exact code space (scale 1/2, zero 0), the prune over codes
    codes = (2 * x + rng.integers(-1, 2, x.shape)).astype(np.int8)
    rqx = RQ.QuantizedCorpus(codes=jnp.asarray(codes), scale=jnp.full((DIM,), 0.5, jnp.float32),
                             zero=jnp.zeros((DIM,), jnp.float32))
    x_hat = codes.astype(np.float32) * 0.5
    cfg = RRD.RNNDescentConfig(**RNN)
    g = g0 = RRD.random_init(key, jnp.asarray(x_hat), cfg)
    for t1 in range(cfg.t1):
        for _ in range(cfg.t2):
            g = RRD.update_neighbors(jnp.asarray(x_hat), g, cfg, qx=rqx)
        if t1 != cfg.t1 - 1:
            g = RRD.add_reverse_edges(g, cfg)
    ref["rnn_int8"] = g
    cases["rnn_int8"] = ("rnn", torch.from_numpy(x_hat), rd.RNNDescentConfig(**RNN), _port(g0),
                         convert.quantized_from_numpy(tuple(rqx), device="cpu"), None)
    # the reverse pass alone, on the graph after one sweep
    cfg = RRD.RNNDescentConfig(**RNN)
    g_in = RRD.update_neighbors(xj, RRD.random_init(key, xj, cfg), cfg)
    ref["reverse"] = RG.add_reverse_edges(g_in, cfg.r, merge="bucketed")
    # a candidate list merged into that graph's rows (bucketed)
    m = 5000
    c_src = rng.integers(-1, N, m).astype(np.int32)
    c_dst = rng.integers(-1, N, m).astype(np.int32)
    c_dist = rng.integers(0, 60, m).astype(np.float32)
    ref["merge"] = RG.merge_candidate_edges(g_in, jnp.asarray(c_src), jnp.asarray(c_dst),
                                            jnp.asarray(c_dist), merge="bucketed")
    # a candidate list with priorities for the two exchanges
    m = 6000
    src = rng.integers(-1, N, m).astype(np.int32)
    dst = rng.integers(-1, N, m).astype(np.int32)
    dist = rng.integers(0, 50, m).astype(np.float32)
    prio = rng.integers(0, 2, m).astype(np.int32)
    ref["exchange"] = RG.bucket_scatter_tables(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(dist),
        jnp.full((m,), RG.NEW, jnp.uint8), N, 128, prio=jnp.asarray(prio))
    extra = {
        "reverse": (_port(g_in), cfg.r, None),
        "merge": (_port(g_in), tuple(torch.from_numpy(a) for a in (c_src, c_dst, c_dist))),
        "sort": (xt, rd.RNNDescentConfig(**RNN, merge="sort")),
        "exchange": tuple(torch.from_numpy(a) for a in (src, dst, dist, prio)) + (N, 128),
        "route": (xt, rd.RNNDescentConfig(**RNN)),
    }
    # the reference's own sharded builds on its 1-device mesh
    mesh1 = jax.make_mesh((1,), ("data",))
    ref["mesh1", "rnn_l2"] = RSH.build_rnn_descent(xj, RRD.RNNDescentConfig(**RNN), key, mesh1)
    ref["mesh1", "nnd_l2"] = RSH.build_nn_descent(xj, RN.NNDescentConfig(**NND), key, mesh1)
    ref["mesh1", "nsg_l2"] = RSH.build_nsg_style(
        xj, RNS.NSGStyleConfig(**NSG, knn=RN.NNDescentConfig(**NND)), key, mesh1,
        entry=cases["nsg_l2"][5])
    return cases, extra, ref


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, reference):
    cases, extra, _ = reference
    return W.run(W.builds, request.param, cases, extra)


@pytest.mark.parametrize("name", BUILDS)
def test_sharded_build_matches_reference(ranks, reference, name):
    ref = reference[2][name]
    for res in ranks:            # every rank returns the whole graph
        _equal(res[name], ref)


@pytest.mark.parametrize("name", ["rnn_l2", "nnd_l2", "nsg_l2"])
def test_reference_one_device_mesh_build_matches(ranks, reference, name):
    _equal(ranks[0][name], reference[2]["mesh1", name])


def test_sharded_reverse_edges_match_reference(ranks, reference):
    for res in ranks:
        _equal(res["reverse"], reference[2]["reverse"])


def test_sharded_candidate_merge_matches_reference(ranks, reference):
    """``shard.merge_candidate_edges`` with each rank passing its share of
    the list equals the reference's single-device bucketed merge."""
    for res in ranks:
        _equal(res["merge"], reference[2]["merge"])


def test_sort_merge_raises(ranks):
    assert all(res["sort_raises"] for res in ranks)


def test_ring_exchange_equals_all_to_all_and_the_full_scatter(ranks, reference):
    """Each rank's block, by the ring and by the all_to_all, equals the
    reference's full-height scatter of the whole candidate list."""
    assert all(res["exchange_equal"] for res in ranks)
    p, k, i, f = (torch.cat([res["exchange_block"][c] for res in ranks])[:N]
                  for c in range(4))
    rp, rk, ri, rf = reference[2]["exchange"]
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(convert.key_to_reference(k), np.asarray(rk))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))


def test_build_route_draws_one_initial_graph(ranks):
    """rnn_descent.build(mesh=) from a generator: every rank draws the same
    RandomGraph(S) (checked inside) and returns the single-device graph;
    with 4 ranks also on a (2, 2) ("data", "model") mesh, whose rows shard
    over "data" alone."""
    for res in ranks:
        for key in ("route", "mesh_2x2") if len(ranks) == 4 else ("route",):
            for a, b in zip(res[key], res["route_single"]):
                assert torch.equal(a, b)


def test_sweep_wire_bytes_follow_the_closed_form(ranks, reference):
    """ppermute bytes a rank sent over the builds it ran equal the closed
    forms of ``shard._exchange_attrs`` summed over those builds' exchanges."""
    from types import SimpleNamespace
    d = len(ranks)
    mesh = SimpleNamespace(axis_names=("data",), shape={"data": d})
    cases, extra, _ = reference

    def wire(b, slot):
        return shard._exchange_attrs(N, mesh, b, slot)["exchange_bytes_per_device"]

    want = 0
    for kind, _x, cfg, *_ in cases.values():
        if kind == "rnn":
            want += cfg.t1 * cfg.t2 * wire(128, 9) + (cfg.t1 - 1) * wire(128, 22)
        elif kind == "nnd":
            want += cfg.iters * wire(nnd.default_join_buckets(cfg, cfg.k), 8)
        else:
            want += cfg.knn.iters * wire(nnd.default_join_buckets(cfg.knn, cfg.knn.k), 8) \
                + wire(128, 22)
    want += wire(128, 22)                                     # the reverse pass alone
    want += wire(128, 9)                                      # the candidate merge
    want += wire(128, 13)                                     # the ring exchange check
    rnn = extra["route"][1]              # the (2, 2) mesh keeps counters of its own
    want += rnn.t1 * rnn.t2 * wire(128, 9) + (rnn.t1 - 1) * wire(128, 22)
    for res in ranks:
        assert res["stats"]["ppermute"]["sent_bytes"] == want
        assert res["stats"]["ppermute"]["staged_bytes"] == 0      # CPU tensors


def test_traced_sharded_build_equals_untraced_with_the_reference_spans(ranks, reference):
    """Traced on every rank: the untraced graph, the reference's span names in
    its order, and readouts over each rank's rows that sum to the
    reference's whole-graph readouts."""
    from repro import obs as robs
    from repro.obs import trace as rtrace
    cases, _, ref = reference
    robs.reset()
    robs.enable(install_jax_hooks=False)
    try:
        RRD.build(jnp.asarray(cases["rnn_l2"][1].numpy()), RRD.RNNDescentConfig(**RNN),
                  jax.random.PRNGKey(1))
        want = [(e["name"], e["attrs"]) for e in rtrace.events()]
    finally:
        robs.disable()
        robs.reset()
    for res in ranks:
        _equal(res["traced"][0], ref["rnn_l2"])
        assert [n for n, _ in res["traced"][1]] == [n for n, _ in want]
    for i, (_, attrs) in enumerate(want):
        spans = [res["traced"][1][i][1] for res in ranks]
        for key in ("edges_live", "edges_new"):
            assert sum(a[key] for a in spans) == attrs[key], (i, key)
        assert all(a["exchange_hops"] == len(ranks) - 1 for a in spans)


def test_collectives_pass_within_budget(ranks):
    """The collectives pass's counts from every rank: the build's ring bytes
    at the closed form exactly (within the budget), the corpus-sharded
    search under one corpus broadcast."""
    from repro_torch.analysis import collectives as CL
    world = len(ranks)
    results = [res["collectives"] for res in ranks]
    assert CL.findings_of(results, world, log=lambda *a, **k: None) == []
    exact = CL.budget_bytes(CL.BUILD_N, world, CL._build_cfg(), factor=1.0)
    assert all(r["build_ring_bytes"] == exact for r in results)
    assert CL.findings_of(results, world, factor=0.5, log=lambda *a, **k: None) != []
