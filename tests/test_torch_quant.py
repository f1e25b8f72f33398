"""Port parity: the int8 and PQ codecs and the shared decode-and-score math
against the reference (JAX, CPU).

Codes, scales and zero points are compared exactly. Codebooks trained by
both sides from the same initial rows are held to 1e-5 (the centroid sums
add in another order: a one-hot matmul there, a float64 ``index_add_``
here). Scores are held to 1e-5 relative on Gaussian data, and exactly where
every product and sum is exact in f32: dyadic ``scale``, integer ``zero``,
integer codebooks and integer queries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as RQ
from repro_torch import convert
from repro_torch import quant as Q

torch.set_num_threads(1)
METRICS = ("l2", "ip", "cos")


def _gauss(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("masked", [False, True])
def test_int8_codec_matches_reference_exactly(masked):
    x = _gauss(0, 300, 24, scale=3.0)
    valid = np.random.default_rng(1).random(300) < 0.7 if masked else None
    ref = RQ.quantize_int8(jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    out = Q.quantize_int8(torch.from_numpy(x), None if valid is None else torch.from_numpy(valid))
    for name in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(out, name)), np.asarray(getattr(ref, name)))
    assert out.codes.dtype == torch.int8 and out.mode == "int8"
    np.testing.assert_array_equal(_np(Q.dequantize(out)), np.asarray(RQ.dequantize(ref)))
    # frozen-space re-encode of new rows
    new = _gauss(2, 40, 24, scale=4.0)
    np.testing.assert_array_equal(_np(Q.encode_rows(torch.from_numpy(new), out)),
                                  np.asarray(RQ.encode_rows(jnp.asarray(new), ref)))


def test_encode_corpus_int8_with_train_rows_matches_reference():
    x = _gauss(3, 200, 16)
    quant = Q.Quantization(mode="int8")
    ref = RQ.encode_corpus(jnp.asarray(x), RQ.Quantization(mode="int8"),
                           train_rows=jnp.asarray(x[:50]))
    out = Q.encode_corpus(torch.from_numpy(x), quant, train_rows=torch.from_numpy(x[:50]))
    for a, b in zip(convert.quantized_to_numpy(out), (ref.codes, ref.scale, ref.zero)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert Q.encode_corpus(torch.from_numpy(x), Q.Quantization()) is None


@pytest.fixture(scope="module")
def pq_ref():
    """The reference's codebooks (m = 6 over d = 24) on a Gaussian corpus."""
    x = _gauss(4, 400, 24)
    cb = np.array(RQ.train_pq(jnp.asarray(x), 6, iters=4, seed=3))
    return x, cb


def test_pq_encode_and_decode_match_reference_with_its_codebooks(pq_ref):
    x, cb = pq_ref
    ref = np.array(RQ.encode_pq_rows(jnp.asarray(x), jnp.asarray(cb)))
    out = Q.encode_pq_rows(torch.from_numpy(x), torch.from_numpy(cb))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        Q.decode_pq(torch.from_numpy(ref), torch.from_numpy(cb)).numpy(),
        np.asarray(RQ.decode_pq(jnp.asarray(ref), jnp.asarray(cb))))
    # row blocks change nothing
    blocked = Q.quantization.ROWS_PER_BLOCK
    try:
        Q.quantization.ROWS_PER_BLOCK = 7
        np.testing.assert_array_equal(
            Q.encode_pq_rows(torch.from_numpy(x), torch.from_numpy(cb)).numpy(), ref)
    finally:
        Q.quantization.ROWS_PER_BLOCK = blocked


@pytest.mark.parametrize("n", [400, 150])   # n < 256: repeated init rows, empty clusters
def test_lloyd_from_the_reference_init_matches_its_codebooks(n):
    m, iters, seed = 6, 4, 3
    x = _gauss(5, n, 24)
    ref = np.asarray(RQ.train_pq(jnp.asarray(x), m, iters=iters, seed=seed))
    # the reference's initial rows, drawn by jax inside the test
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    init_idx = perm[np.arange(256) % n]
    cents = torch.from_numpy(x[init_idx].reshape(256, m, 4).transpose(1, 0, 2).copy())
    out = Q.pq_lloyd(torch.from_numpy(x), cents, iters)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_train_pq_is_seeded_and_deterministic():
    x = torch.from_numpy(_gauss(6, 300, 16))
    a, b = Q.train_pq(x, 4, 3, seed=1), Q.train_pq(x, 4, 3, seed=1)
    assert a.shape == (4, 256, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, Q.train_pq(x, 4, 3, seed=2))
    # distinct rows at n >= 256 (a permutation prefix)
    init = Q.pq_init(x, 4, seed=1)
    assert torch.unique(init.transpose(0, 1).reshape(256, -1), dim=0).shape[0] == 256
    with pytest.raises(ValueError, match="d % m"):
        Q.train_pq(x, 5)
    # row blocks change nothing (the float64 sums of f32 rows are exact here)
    blocked = Q.quantization.ROWS_PER_BLOCK
    try:
        Q.quantization.ROWS_PER_BLOCK = 7
        torch.testing.assert_close(Q.train_pq(x, 4, 3, seed=1), a, rtol=0, atol=0)
    finally:
        Q.quantization.ROWS_PER_BLOCK = blocked


def _int8_exact():
    """A code space where decode and every score is exact in f32."""
    rng = np.random.default_rng(7)
    codes = rng.integers(-127, 128, (60, 16)).astype(np.int8)
    scale = (2.0 ** -rng.integers(0, 3, 16)).astype(np.float32)   # dyadic
    zero = rng.integers(-3, 4, 16).astype(np.float32)
    q = rng.integers(-8, 9, (5, 16)).astype(np.float32)
    return codes, scale, zero, q


@pytest.mark.parametrize("metric", METRICS)
def test_int8_score_block_matches_reference(metric):
    rng = np.random.default_rng(8)
    codes = rng.integers(-127, 128, (5, 9, 24)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, 24).astype(np.float32)
    zero = rng.standard_normal(24).astype(np.float32)
    q = _gauss(9, 5, 24)
    ref = np.asarray(RQ.int8_score_block(*(jnp.asarray(a) for a in (codes, scale, zero, q)),
                                         metric))
    out = Q.int8_score_block(*(torch.from_numpy(a) for a in (codes, scale, zero, q)), metric)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    if metric == "cos":
        return
    codes, scale, zero, q = _int8_exact()
    blk = codes.reshape(5, 12, 16)
    ref = np.asarray(RQ.int8_score_block(*(jnp.asarray(a) for a in (blk, scale, zero, q)),
                                         metric))
    out = Q.int8_score_block(*(torch.from_numpy(a) for a in (blk, scale, zero, q)), metric)
    np.testing.assert_array_equal(out.numpy(), ref)


def _pq_inputs(integer: bool, b=5, m=4, dsub=3, k=7):
    rng = np.random.default_rng(10)
    if integer:
        cb = rng.integers(-4, 5, (m, 256, dsub)).astype(np.float32)
        q = rng.integers(-4, 5, (b, m * dsub)).astype(np.float32)
    else:
        cb = rng.standard_normal((m, 256, dsub)).astype(np.float32)
        q = rng.standard_normal((b, m * dsub)).astype(np.float32)
    codes = rng.integers(0, 256, (b, k, m)).astype(np.uint8)
    return cb, q, codes


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_pq_lut_and_score_codes_match_reference(metric, integer):
    cb, q, codes = _pq_inputs(integer)
    ref = RQ.pq_lut(jnp.asarray(q), jnp.asarray(cb), metric)
    out = Q.pq_lut(torch.from_numpy(q), torch.from_numpy(cb), metric)
    ref_s = np.asarray(RQ.pq_score_codes(jnp.asarray(codes), *ref, metric))
    out_s = Q.pq_score_codes(torch.from_numpy(codes), *out, metric).numpy()
    if integer and metric != "cos":
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(out_s, ref_s)
    else:
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out_s, ref_s, rtol=1e-5, atol=1e-5)
    # the tables score the decoded rows as score_block would (l2, ip exactly
    # on integers)
    if integer and metric != "cos":
        from repro_torch.kernels.beam_score.ref import score_block
        rows = Q.decode_pq(torch.from_numpy(codes), torch.from_numpy(cb))
        np.testing.assert_array_equal(score_block(rows, torch.from_numpy(q), metric).numpy(),
                                      out_s)


def test_corpus_bytes_matches_reference():
    x = _gauss(11, 300, 16)
    for mode, extra in (("int8", {}), ("pq", {"m": 4, "pq_iters": 2})):
        ref = RQ.corpus_bytes(RQ.encode_corpus(jnp.asarray(x), RQ.Quantization(mode=mode, **extra)),
                              300, 16)
        out = Q.corpus_bytes(Q.encode_corpus(torch.from_numpy(x), Q.Quantization(mode=mode, **extra)),
                             300, 16)
        assert out == ref
    assert Q.corpus_bytes(None, 300, 16) == RQ.corpus_bytes(None, 300, 16)


def test_quantization_validation_matches_reference():
    for kw in (dict(mode="int4"), dict(m=0), dict(pq_iters=0), dict(rerank_k=-1)):
        with pytest.raises(ValueError):
            RQ.Quantization(**kw)
        with pytest.raises(ValueError):
            Q.Quantization(**kw)
    for mode in Q.MODES:
        assert Q.Quantization(mode=mode).is_coded == RQ.Quantization(mode=mode).is_coded
    assert dataclasses.asdict(Q.Quantization()) == dataclasses.asdict(RQ.Quantization())


def test_prep_corpus_matches_reference():
    x = _gauss(12, 300, 16)
    for quant in (RQ.Quantization(mode="int8"), RQ.Quantization(mode="pq", m=4, pq_iters=2),
                  RQ.Quantization(mode="bf16")):
        rx, rqx = RQ.prep_corpus(jnp.asarray(x), quant)
        px, pqx = Q.prep_corpus(torch.from_numpy(x), Q.Quantization(**dataclasses.asdict(quant)))
        assert (pqx is None) == (rqx is None)
        if quant.mode == "pq":   # codebooks differ (another init); shapes agree
            assert px.shape == rx.shape
        else:
            np.testing.assert_array_equal(px.numpy(), np.asarray(rx))


def test_quantized_corpus_crosses_through_numpy():
    x = _gauss(13, 100, 16)
    ref = RQ.encode_corpus(jnp.asarray(x), RQ.Quantization(mode="pq", m=4, pq_iters=2))
    port = convert.quantized_from_numpy(ref, device="cpu")
    assert port.mode == "pq" and port.scale is None and port.codes.dtype == torch.uint8
    back = convert.quantized_to_numpy(port)
    np.testing.assert_array_equal(back[0], np.asarray(ref.codes))
    np.testing.assert_array_equal(back[3], np.asarray(ref.codebooks))
