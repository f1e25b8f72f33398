"""Port parity: the plain versions of the coded kernels (``beam_score_int8``,
``beam_score_pq``, ``rng_prune_int8``) against the reference's oracles and
its Pallas functions in interpret mode (JAX, CPU), and one int8 RNN-Descent
sweep.

Tolerances: ids exact everywhere. Distances within 1e-5 on real-valued
inputs (sums in another order); keys and distances exact on integer-valued
inputs (dyadic ``scale``, integer ``zero``, integer codes, codebooks and
queries), where every f32 product and sum is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as RQ
from repro.core import distances as RD
from repro.core import graph as RG
from repro.core import rnn_descent as RRD
from repro.kernels.beam_score import (
    beam_score_int8 as pallas_beam_score_int8,
    beam_score_int8_ref as ref_beam_score_int8,
    beam_score_pq as pallas_beam_score_pq,
    beam_score_pq_ref as ref_beam_score_pq,
    beam_score_ref as ref_beam_score_f32,
)
from repro.kernels.rng_prune import rng_prune_int8 as pallas_rng_prune_int8
from repro_torch import convert
from repro_torch import quant as Q
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.kernels.beam_score import ops as bs_ops
from repro_torch.kernels.rng_prune import ops as rng_ops

torch.set_num_threads(1)
METRICS = ("l2", "ip", "cos")


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _int8_space(seed, n, d, integer):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    if integer:
        scale = (2.0 ** -rng.integers(1, 4, d)).astype(np.float32)
        zero = rng.integers(-3, 4, d).astype(np.float32)
    else:
        scale = rng.uniform(0.005, 0.05, d).astype(np.float32)
        zero = rng.standard_normal(d).astype(np.float32)
    return codes, scale, zero


def _frontier(seed, n, m, b, d, integer, n_valid=9):
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, (n, m)).astype(np.int32)
    nbrs[:, n_valid:] = -1
    nbrs[::7, 2] = -1                                  # holes inside the prefix too
    u = rng.integers(0, n, b).astype(np.int32)
    q = (rng.integers(-8, 9, (b, d)) if integer else rng.standard_normal((b, d)))
    return nbrs, u, q.astype(np.float32)


def _compare(out, ref, exact):
    ids, d, keys = out
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref[0]))
    if exact:
        np.testing.assert_array_equal(d.numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(convert.key_to_reference(keys), np.asarray(ref[2]))
    else:
        np.testing.assert_allclose(d.numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(G.key_dist(keys).numpy(), d.numpy())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_score_int8_plain_matches_reference_and_pallas(metric, integer):
    n, d = 120, 16
    codes, scale, zero = _int8_space(0, n, d, integer)
    nbrs, u, q = _frontier(1, n, 12, 24, d, integer)
    args = (codes, scale, zero, nbrs, u, q)
    out = bs_ops.beam_score_int8(*_t(*args), k=10, metric=metric)
    exact = integer and metric != "cos"
    ja = tuple(jnp.asarray(a) for a in args)
    _compare(out, ref_beam_score_int8(*ja, k=10, metric=metric), exact)
    _compare(out, pallas_beam_score_int8(*ja, k=10, metric=metric, tile_b=8), exact)
    # k is clipped to the capacity
    assert bs_ops.beam_score_int8(*_t(*args), k=99, metric=metric)[0].shape == (24, 12)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_score_pq_plain_matches_reference_and_pallas(metric, integer):
    n, m, dsub = 120, 4, 4
    rng = np.random.default_rng(2)
    cb = (rng.integers(-4, 5, (m, 256, dsub)) if integer
          else rng.standard_normal((m, 256, dsub))).astype(np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    nbrs, u, q = _frontier(3, n, 12, 24, m * dsub, integer)
    lut = RQ.pq_lut(jnp.asarray(q), jnp.asarray(cb), metric)
    plut = Q.pq_lut(*_t(q, cb), metric)
    out = bs_ops.beam_score_pq(*_t(codes, nbrs, u), *plut, k=10, metric=metric)
    exact = integer and metric != "cos"
    ja = (jnp.asarray(codes), jnp.asarray(nbrs), jnp.asarray(u))
    _compare(out, ref_beam_score_pq(*ja, *lut, k=10, metric=metric), exact)
    _compare(out, pallas_beam_score_pq(*ja, *lut, k=10, metric=metric, tile_b=8), exact)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["f32", "int8", "pq"])
def test_plain_beam_versions_pad_a_frontier_id_outside_the_corpus(kind, metric):
    """A frontier id outside [0, n) (-1 for a retired lane, n, 2^31 - 1)
    gives a lane of padding, as in the kernels, and an adjacency id >= n a
    padded slot; the other lanes equal the reference's oracles (given -1 in
    that slot) on integer-valued inputs, exactly for l2 and ip."""
    n, m, b, k = 120, 12, 24, 10
    codes, scale, zero = _int8_space(7, n, 16, integer=True)
    nbrs, u, q = _frontier(8, n, m, b, 16, integer=True)
    bad = np.zeros(b, bool)
    bad[[1, 6, 11, 17]] = True
    u_bad = u.copy()
    u_bad[[1, 6, 11, 17]] = [-1, n, 2**31 - 1, -1]
    planted = nbrs.copy()
    planted[u[0], [1, 4]] = [n, n + 7]
    nbrs[u[0], [1, 4]] = -1
    if kind == "f32":
        x = (codes.astype(np.float32) * scale + zero).astype(np.float32)
        out = bs_ops.beam_score(*_t(x, planted, u_bad, q), k=k, metric=metric)
        ref = ref_beam_score_f32(*(jnp.asarray(a) for a in (x, nbrs, u, q)), k=k,
                                 metric=metric)
    elif kind == "int8":
        out = bs_ops.beam_score_int8(*_t(codes, scale, zero, planted, u_bad, q), k=k,
                                     metric=metric)
        ref = ref_beam_score_int8(*(jnp.asarray(a) for a in (codes, scale, zero, nbrs, u, q)),
                                  k=k, metric=metric)
    else:
        rng = np.random.default_rng(9)
        cb = rng.integers(-4, 5, (4, 256, 4)).astype(np.float32)
        pq = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        out = bs_ops.beam_score_pq(*_t(pq, planted, u_bad), *Q.pq_lut(*_t(q, cb), metric), k=k,
                                   metric=metric)
        ref = ref_beam_score_pq(*(jnp.asarray(a) for a in (pq, nbrs, u)),
                                *RQ.pq_lut(jnp.asarray(q), jnp.asarray(cb), metric), k=k,
                                metric=metric)
    ids, d, keys = out
    np.testing.assert_array_equal(ids[bad].numpy(), -1)
    assert bool(torch.isinf(d[bad]).all()) and bool((d[bad] > 0).all())
    np.testing.assert_array_equal(keys[bad].numpy(), G.dist_key(d[bad]).numpy())
    good = tuple(t[~torch.from_numpy(bad)] for t in out)
    _compare(good, tuple(np.asarray(r)[~bad] for r in ref), metric != "cos")


def _int_graph_rows(seed, x, rows, m, metric):
    """Distance-sorted candidate rows over ``x`` with -1 pads and a NEW/OLD
    flag mix (rows are vertices 0 .. rows - 1, never their own candidate: a
    self entry ties every pair distance with a row distance)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    ids = rng.integers(-1, n, (rows, m)).astype(np.int32)
    ids[ids == np.arange(rows)[:, None]] = -1
    ids = np.asarray(RG.dedup_row_ids(jnp.asarray(ids)))
    src = np.repeat(np.arange(rows, dtype=np.int32), m)
    dist = np.asarray(RD.gather_dists(jnp.asarray(x), jnp.asarray(src),
                                      jnp.asarray(ids.reshape(-1)), metric)).reshape(rows, m)
    flags = np.where(ids >= 0, rng.integers(0, 2, (rows, m)), 0).astype(np.uint8)
    g = RG.sort_rows(RG.Graph(jnp.asarray(ids), jnp.asarray(dist), jnp.asarray(flags)))
    return tuple(np.array(a) for a in g)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_rng_prune_int8_plain_matches_reference_prune(metric, integer):
    """Against the reference's jnp prune (decode after the gather, then
    ``batched_gram`` under the metric) for every metric, and against its
    Pallas int8 prune (interpret) for l2, the one metric that body forms."""
    codes, scale, zero = _int8_space(4, 300, 16, integer)
    qx = RQ.QuantizedCorpus(codes=jnp.asarray(codes), scale=jnp.asarray(scale),
                            zero=jnp.asarray(zero))
    xh = np.asarray(RQ.dequantize(qx))
    ids, dists, flags = _int_graph_rows(5, xh, 100, 32, metric)
    cfg = RRD.RNNDescentConfig(s=8, r=16, capacity=32, chunk=32, metric=metric)
    ref = RRD.prune_rows(jnp.asarray(xh), jnp.asarray(ids), jnp.asarray(dists),
                         jnp.asarray(flags), cfg, qx=qx)
    out = rng_ops.rng_prune_int8(*_t(codes, scale, zero, ids, dists, flags), metric=metric,
                                 chunk=7)
    exact = integer and metric != "cos"
    np.testing.assert_array_equal(out[0].numpy().astype(bool), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    if exact:
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    else:
        np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-5, atol=1e-5)
    if metric == "l2":
        pal = pallas_rng_prune_int8(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero),
                                    jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(flags))
        np.testing.assert_array_equal(out[0].numpy().astype(bool), np.asarray(pal[0]))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(pal[1]))
        np.testing.assert_allclose(out[2].numpy(), np.asarray(pal[2]), rtol=1e-5, atol=1e-5)
    # the plain version is the f32 prune over the decoded rows
    f32 = rng_ops.rng_prune(*_t(xh, ids, dists, flags), metric=metric)
    for a, b in zip(out, f32):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("merge", ["sort", "bucketed"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int8_update_neighbors_sweep_matches_reference(metric, merge):
    """One sweep over the codes of an integer-valued code space, from a
    graph the reference built over the decoded corpus: exact."""
    codes, scale, zero = _int8_space(6, 300, 16, integer=True)
    qx = RQ.QuantizedCorpus(codes=jnp.asarray(codes), scale=jnp.asarray(scale),
                            zero=jnp.asarray(zero))
    xh = RQ.dequantize(qx)
    cfg = RRD.RNNDescentConfig(s=6, r=10, t1=2, t2=2, capacity=16, chunk=64, metric=metric,
                               merge=merge, quant=RQ.Quantization(mode="int8"))
    g = RRD.random_init(jax.random.PRNGKey(7), xh, cfg)
    for _ in range(2):
        g = RRD.update_neighbors(xh, g, cfg, qx=qx)
    ref = RRD.update_neighbors(xh, g, cfg, qx=qx)
    pcfg = rd.RNNDescentConfig(s=6, r=10, t1=2, t2=2, capacity=16, chunk=64, metric=metric,
                               merge=merge, quant=Q.Quantization(mode="int8"))
    pg = convert.graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    pqx = convert.quantized_from_numpy(qx, device="cpu")
    out = rd.update_neighbors(torch.from_numpy(np.array(xh)), pg, pcfg, qx=pqx)
    for a, b in zip(convert.graph_to_numpy(out), ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_coded_wrappers_reject_what_the_kernels_do_not_take():
    codes = torch.zeros(10, 8, dtype=torch.int8)
    scale, zero = torch.ones(8), torch.zeros(8)
    ids = torch.zeros(3, 5, dtype=torch.int32)
    d = torch.zeros(3, 5)
    f = torch.zeros(3, 5, dtype=torch.uint8)
    with pytest.raises(ValueError, match="x must be"):
        rng_ops.rng_prune_int8(codes.float(), scale, zero, ids, d, f)
    with pytest.raises(ValueError, match="scale must be"):
        rng_ops.rng_prune_int8(codes, scale[:4], zero, ids, d, f)
    with pytest.raises(ValueError, match="metric"):
        rng_ops.rng_prune_int8(codes, scale, zero, ids, d, f, metric="hamming")
    nb = torch.zeros(10, 4, dtype=torch.int32)
    u = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="queries must be"):
        bs_ops.beam_score_int8(codes, scale, zero, nb, u, torch.zeros(3, 7), 2)
    with pytest.raises(ValueError, match="zero must be"):
        bs_ops.beam_score_int8(codes, scale, zero.double(), nb, u, torch.zeros(3, 8), 2)
    pq = torch.zeros(10, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="x must be"):
        bs_ops.beam_score_pq(pq.to(torch.int8), nb, u, torch.zeros(3, 4, 256),
                             torch.zeros(4, 256), torch.zeros(3), 2)
    with pytest.raises(ValueError, match="lut_a must be"):
        bs_ops.beam_score_pq(pq, nb, u, torch.zeros(3, 4, 255), torch.zeros(4, 256),
                             torch.zeros(3), 2)
    with pytest.raises(ValueError, match="qsq must be"):
        bs_ops.beam_score_pq(pq, nb, u, torch.zeros(3, 4, 256), torch.zeros(4, 256),
                             torch.zeros(3, 1), 2)
    # frontier ids, adjacency and query batch of the wrong type or shape
    with pytest.raises(ValueError, match="u must be"):
        bs_ops.beam_score_int8(codes, scale, zero, nb, u.long(), torch.zeros(3, 8), 2)
    with pytest.raises(ValueError, match="u must be"):
        bs_ops.beam_score_pq(pq, nb, u[:, None], torch.zeros(3, 4, 256), torch.zeros(4, 256),
                             torch.zeros(3), 2)
    with pytest.raises(ValueError, match="neighbors must be"):
        bs_ops.beam_score_int8(codes, scale, zero, nb[:9], u, torch.zeros(3, 8), 2)
    with pytest.raises(ValueError, match="neighbors must be"):
        bs_ops.beam_score_pq(pq, nb.long(), u, torch.zeros(3, 4, 256), torch.zeros(4, 256),
                             torch.zeros(3), 2)
    with pytest.raises(ValueError, match="queries must be"):
        bs_ops.beam_score_int8(codes, scale, zero, nb, u, torch.zeros(3, 8).double(), 2)
    with pytest.raises(ValueError, match="x must be"):
        bs_ops.beam_score_int8(codes[0], scale, zero, nb, u, torch.zeros(3, 8), 2)
    with pytest.raises(ValueError, match="lut_a must be"):
        bs_ops.beam_score_pq(pq, nb, u, torch.zeros(4, 4, 256), torch.zeros(4, 256),
                             torch.zeros(3), 2)
    with pytest.raises(ValueError, match="metric"):
        bs_ops.beam_score_pq(pq, nb, u, torch.zeros(3, 4, 256), torch.zeros(4, 256),
                             torch.zeros(3), 2, metric="hamming")
