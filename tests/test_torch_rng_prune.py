"""Port parity: the RNG scan, the plain fused prune and one RNN-Descent sweep
against the reference (JAX, CPU, jnp paths).

Corpora are integer-valued (numpy integers in [-8, 8], d <= 32): every l2 and
ip distance is then exact in f32 whatever the summation order, so ids, keep
masks, redirects and distances are compared exactly. cos normalises, so it is
compared by feeding both scans the reference's own pair matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _ragged import ragged_rows

from repro.core import distances as RD
from repro.core import graph as RG
from repro.core import rnn_descent as RRD
from repro.core.rng import rng_scan as ref_rng_scan
from repro.kernels.rng_prune.ref import rng_prune_int8_ref as jax_rng_prune_int8_ref
from repro.kernels.rng_prune.ref import rng_prune_ref as jax_rng_prune_ref
from repro_torch import convert
from repro_torch.core import rnn_descent as rd
from repro_torch.core.rng import rng_prune_rows, rng_scan
from repro_torch.kernels.rng_prune import ops as rng_ops
from repro_torch.kernels.rng_prune.ref import rng_prune_ref

torch.set_num_threads(1)


def _int_corpus(seed, n, d=16):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def _cand_rows(seed, x, rows, m, metric):
    """Distance-sorted candidate rows with -1 pads and a NEW/OLD flag mix."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    ids = rng.integers(-1, n, (rows, m)).astype(np.int32)
    ids = np.asarray(RG.dedup_row_ids(jnp.asarray(ids)))
    src = np.repeat(np.arange(rows, dtype=np.int32), m)
    dist = np.asarray(RD.gather_dists(jnp.asarray(x), jnp.asarray(src),
                                      jnp.asarray(ids.reshape(-1)), metric)).reshape(rows, m)
    flags = rng.integers(0, 2, (rows, m)).astype(np.uint8)
    g = RG.sort_rows(RG.Graph(jnp.asarray(ids), jnp.asarray(dist),
                              jnp.asarray(np.where(ids >= 0, flags, 0).astype(np.uint8))))
    return tuple(np.array(a) for a in g)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_rng_scan_matches_reference_on_its_pair_matrix(metric):
    x = _int_corpus(0, 200)
    ids, dists, flags = _cand_rows(1, x, 64, 24, metric)
    vecs = jnp.asarray(x)[jnp.maximum(jnp.asarray(ids), 0)]
    pair = RD.batched_gram(vecs, metric)
    old = flags == 0
    skip = old[:, :, None] & old[:, None, :]
    ref = ref_rng_scan(jnp.asarray(ids), jnp.asarray(dists), pair, jnp.asarray(skip))
    out = rng_scan(*_t(ids, dists, pair), skip_pair=torch.from_numpy(skip))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # no exemption (plain Algorithm 3) as well
    ref = ref_rng_scan(jnp.asarray(ids), jnp.asarray(dists), pair)
    out = rng_scan(*_t(ids, dists, pair))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_rng_prune_is_the_oracle_on_integer_data(metric):
    """The chunked plain prune (what a CPU tensor runs) equals the
    unchunked oracle over the gathered block; for l2 both equal the
    reference's own rng_prune_ref (which is L2-only)."""
    x = _int_corpus(2, 300)
    ids, dists, flags = _cand_rows(3, x, 100, 32, metric)
    tx, tids, tdists, tflags = _t(x, ids, dists, flags)
    out = rng_ops.rng_prune(tx, tids, tdists, tflags, metric=metric, chunk=7)
    want = rng_prune_ref(tids, tdists, tflags, tx[tids.clamp(min=0).long()], metric)
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if metric == "l2":
        ref = jax_rng_prune_ref(jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(flags),
                                jnp.asarray(x)[jnp.maximum(jnp.asarray(ids), 0)])
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("m", [50, 128])
@pytest.mark.parametrize("corpus,metric", [("f32", "l2"), ("f32", "ip"), ("int8", "l2")])
def test_plain_rng_prune_matches_reference_on_ragged_rows(corpus, metric, m):
    """The contract the CUDA prune is held to on the card: rows of extent 0,
    1, 31, 32, 33, 64, 65, 127, 128 (capped at m) and rows with -1 holes
    below their last valid slot, through the plain prune and the reference's
    jnp prune (gathered Gram + rng_scan, old-old pairs exempt), exactly. The
    ids >= n that the kernel reads as padding reach both as -1."""
    rng = np.random.default_rng(8)
    if corpus == "int8":   # dyadic scale, integer zero: every decoded value exact
        codes = rng.integers(-127, 128, (400, 24)).astype(np.int8)
        scale = (2.0 ** -rng.integers(1, 4, 24)).astype(np.float32)
        zero = rng.integers(-3, 4, 24).astype(np.float32)
        x = codes.astype(np.float32) * scale + zero
    else:
        x = _int_corpus(9, 400, 24)
    _, ids, dists, flags = ragged_rows(x, m, 10, metric, repeats=2)
    if corpus == "int8":
        out = rng_ops.rng_prune_int8(*_t(codes, scale, zero, ids, dists, flags), metric=metric,
                                     chunk=7)
        ref = jax_rng_prune_int8_ref(*(jnp.asarray(a) for a in
                                       (codes, scale, zero, ids, dists, flags)))
    else:
        out = rng_ops.rng_prune(*_t(x, ids, dists, flags), metric=metric, chunk=7)
        vecs = jnp.asarray(x)[jnp.maximum(jnp.asarray(ids), 0)]
        old = flags == 0
        res = ref_rng_scan(jnp.asarray(ids), jnp.asarray(dists), RD.batched_gram(vecs, metric),
                           jnp.asarray(old[:, :, None] & old[:, None, :]))
        ref = (res.keep.astype(jnp.uint8), res.redirect_w, res.redirect_d)
    assert int(out[0].sum()) > 0 and int((out[1] >= 0).sum()) > 0
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rng_prune_rows_keep_matches_reference():
    x = _int_corpus(4, 200)
    ids, dists, _ = _cand_rows(5, x, 80, 16, "l2")
    from repro.core.rng import rng_prune_rows as ref_prune_rows
    ref = ref_prune_rows(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(dists), chunk=32)
    out = rng_prune_rows(*_t(x, ids, dists), chunk=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def ref_state():
    """A reference-built graph (random init + 2 sweeps) on an integer corpus."""
    import jax
    x = _int_corpus(6, 300)
    cfgs = {}
    graphs = {}
    for metric in ("l2", "ip"):
        for merge in ("sort", "bucketed"):
            cfg = RRD.RNNDescentConfig(s=6, r=10, t1=2, t2=2, capacity=16, chunk=64,
                                       metric=metric, merge=merge)
            g = RRD.random_init(jax.random.PRNGKey(7), jnp.asarray(x), cfg)
            for _ in range(2):
                g = RRD.update_neighbors(jnp.asarray(x), g, cfg)
            cfgs[metric, merge], graphs[metric, merge] = cfg, g
    return x, cfgs, graphs


def _port_cfg(cfg):
    return rd.RNNDescentConfig(s=cfg.s, r=cfg.r, t1=cfg.t1, t2=cfg.t2,
                               capacity=cfg.capacity, chunk=cfg.chunk,
                               metric=cfg.metric, merge=cfg.merge)


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_update_neighbors_sweep_matches_reference(ref_state, metric, merge):
    x, cfgs, graphs = ref_state
    cfg, g = cfgs[metric, merge], graphs[metric, merge]
    ref = RRD.update_neighbors(jnp.asarray(x), g, cfg)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    out = rd.update_neighbors(torch.from_numpy(x), pg, _port_cfg(cfg))
    for a, b in zip(convert.graph_to_numpy(out), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_add_reverse_edges_step_matches_reference(ref_state, metric, merge):
    _, cfgs, graphs = ref_state
    cfg, g = cfgs[metric, merge], graphs[metric, merge]
    ref = RRD.add_reverse_edges(g, cfg)
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    out = rd.add_reverse_edges(pg, _port_cfg(cfg))
    for a, b in zip(convert.graph_to_numpy(out), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_whole_build_matches_reference(metric, merge):
    """The port's sweep loop (T1 x T2 update_neighbors, a reverse pass after
    each outer round but the last), started from the reference's own random
    initial graph, gives the reference's built graph bit for bit: drift that
    compounds over sweeps would show here, not in one sweep."""
    import jax
    x = _int_corpus(8, 1500, d=24)
    cfg = RRD.RNNDescentConfig(s=10, r=24, t1=3, t2=4, capacity=32, chunk=512,
                               metric=metric, merge=merge)
    key = jax.random.PRNGKey(9)
    ref = RRD.build(jnp.asarray(x), cfg, key)
    g = convert.graph_from_numpy(*(np.asarray(a) for a in
                                   RRD.random_init(key, jnp.asarray(x), cfg)), device="cpu")
    pcfg, xt = _port_cfg(cfg), torch.from_numpy(x)
    for t1 in range(cfg.t1):
        for _ in range(cfg.t2):
            g = rd.update_neighbors(xt, g, pcfg)
        if t1 != cfg.t1 - 1:
            g = rd.add_reverse_edges(g, pcfg)
    for a, b in zip(convert.graph_to_numpy(g), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_config_validation_matches_reference():
    for kw in ({"capacity": 8, "r": 16}, {"merge": "heap"}):
        with pytest.raises(ValueError):
            RRD.RNNDescentConfig(**kw)
        with pytest.raises(ValueError):
            rd.RNNDescentConfig(**kw)
    with pytest.raises(ValueError, match="gram_dtype"):
        rd.RNNDescentConfig(gram_dtype="f16")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(10, 4)
    ids = torch.zeros(3, 5, dtype=torch.int32)
    d = torch.zeros(3, 5)
    f = torch.zeros(3, 5, dtype=torch.uint8)
    with pytest.raises(ValueError, match="x must be"):
        rng_ops.rng_prune(x.double(), ids, d, f)
    with pytest.raises(ValueError, match="ids must be"):
        rng_ops.rng_prune(x, ids.long(), d, f)
    with pytest.raises(ValueError, match="dists must be"):
        rng_ops.rng_prune(x, ids, d[:, :4], f)
    with pytest.raises(ValueError, match="flags must be"):
        rng_ops.rng_prune(x, ids, d, f.bool())
    with pytest.raises(ValueError, match="metric"):
        rng_ops.rng_prune(x, ids, d, f, metric="hamming")
