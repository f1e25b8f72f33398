"""Port parity: the recsys serving slice (configs, embedding bags, CIN,
forward / serve of FM, DeepFM, Wide&Deep and xDeepFM, candidate scoring,
``launch.steps.bind``) against the reference (JAX, CPU).

Weights come from the reference's ``init`` and cross with
``convert.recsys_params_from_numpy``; batches are numpy draws from a seed.
Both sides run the same bf16 roundings in the same order (gather then cast
is the same bits as cast then gather), so the bf16 embedding bags and CIN
features are equal bit for bit on the CPU; f32 logits, whose sums run in
another order, agree within 1e-6 abs (the largest difference seen over
these inputs is 1.3e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.configs import deepfm as j_deepfm
from repro.configs import fm as j_fm
from repro.configs import wide_deep as j_wide_deep
from repro.configs import xdeepfm as j_xdeepfm
from repro.models import recsys as R
from repro_torch import configs, convert
from repro_torch.configs import base as cb
from repro_torch.configs import deepfm, fm, wide_deep, xdeepfm
from repro_torch.data.synthetic import recsys_batch
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import steps
from repro_torch.models import recsys as rs

torch.set_num_threads(1)

PAIRS = {"fm": (j_fm, fm), "deepfm": (j_deepfm, deepfm), "wide-deep": (j_wide_deep, wide_deep),
         "xdeepfm": (j_xdeepfm, xdeepfm)}
LOGIT_ATOL = 1e-6


def _same_config(jc, pc):
    for field in ("name", "arch", "n_fields", "embed_dim", "vocab_sizes", "n_dense",
                  "multi_hot", "mlp_dims", "cin_dims", "interaction"):
        assert getattr(jc, field) == getattr(pc, field), field
    assert jc.total_vocab == pc.total_vocab and jc.field_offsets == pc.field_offsets
    assert pc.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("n_fields", [6, 39, 40])
@pytest.mark.parametrize("reduced", [False, True])
def test_vocab_sizes_and_pad_to_match_reference(n_fields, reduced):
    assert cb.criteo_vocab_sizes(n_fields, reduced) == jcb.criteo_vocab_sizes(n_fields, reduced)
    total = sum(cb.criteo_vocab_sizes(n_fields, reduced))
    assert cb.pad_to(total) == jcb.pad_to(total) == total
    for n in (1, 4095, 4096, 1_000_000):
        assert cb.pad_to(n) == jcb.pad_to(n)


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
def test_configs_and_shapes_match_reference(arch_id):
    jm, pm = PAIRS[arch_id]
    _same_config(jm.FULL, pm.FULL)
    _same_config(jm.SMOKE, pm.SMOKE)
    arch = configs.get(arch_id)
    assert [(s.name, s.kind, s.dims) for s in arch.shapes] == \
        [(s.name, s.kind, s.dims) for s in jcb.RECSYS_SHAPES]
    assert cb.RECSYS_SMOKE == jcb.RECSYS_SMOKE
    for shape in arch.shapes:
        for reduced in (False, True):
            cfg = arch.make_config(shape.name, reduced)
            want = jcb.recsys_input_specs(jm.SMOKE if reduced else jm.FULL, shape, reduced)
            got = cb.recsys_input_specs(cfg, shape, reduced)
            assert {k: tuple(v.shape) for k, v in want.items()} == \
                {k: s for k, (s, _) in got.items()}


def test_registry_refuses_what_is_not_ported():
    """Every architecture of the reference is ported now: ``dimenet``
    resolves (the gnn family), nothing is left in ``NOT_PORTED``, and an
    unknown id still raises ``KeyError``."""
    assert configs.get("dimenet").family == "gnn"
    assert configs.NOT_PORTED == ()
    with pytest.raises(KeyError):
        configs.get("no-such-arch")
    assert steps.bind("deepfm", "train_batch", reduced=True, device="cpu").kind == "train"
    assert steps.bind("dimenet", "molecule", reduced=True, device="cpu").kind == "train"


def _table(seed, v, d):
    return np.random.default_rng(seed).standard_normal((v, d)).astype(np.float32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_embedding_bag_matches_reference(mode, weighted, bf16):
    rng = np.random.default_rng(1)
    table = _table(0, 50, 6)
    ids = rng.integers(0, 50, (9, 5, 4)).astype(np.int32)
    w = rng.random((9, 5, 4)).astype(np.float32) if weighted else None
    jt = jnp.asarray(table).astype(jnp.bfloat16) if bf16 else jnp.asarray(table)
    want = R.embedding_bag(jt, jnp.asarray(ids), mode, None if w is None else jnp.asarray(w))
    got = rs.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode,
                           None if w is None else torch.from_numpy(w),
                           compute_dtype=torch.bfloat16 if bf16 else None)
    assert str(got.dtype) == f"torch.{want.dtype}"
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if bf16:   # the same bf16 roundings: equal bits
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_ragged_matches_reference(mode):
    """Segment ids outside [0, n_bags) are dropped on both sides; bag 3 is
    empty (mean divides by max(count, 1))."""
    rng = np.random.default_rng(2)
    table = _table(3, 40, 5)
    flat = rng.integers(0, 40, 30).astype(np.int32)
    seg = rng.integers(0, 6, 30).astype(np.int32)
    seg[seg == 3] = 0
    seg[[4, 11]] = -1
    seg[17] = 6
    want = R.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 6,
                                  mode)
    got = rs.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat),
                                  torch.from_numpy(seg), 6, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not got[3].any()


def test_cin_matches_reference():
    """bf16 throughout, the same roundings in the same places: the features
    are equal bit for bit on the CPU."""
    cfg_j, cfg_p = j_xdeepfm.SMOKE, xdeepfm.SMOKE
    params = jax.tree.map(np.asarray, R.init(jax.random.PRNGKey(4), cfg_j)[0])
    x0 = np.random.default_rng(5).standard_normal((8, cfg_p.n_fields, cfg_p.embed_dim))
    x0 = x0.astype(np.float32)
    want = np.asarray(R._cin(params, jnp.asarray(x0).astype(jnp.bfloat16), cfg_j)
                      .astype(jnp.float32))
    tp = convert.recsys_params_from_numpy(params, cfg_p, "cpu")
    got = rs._cin(tp, torch.from_numpy(x0).bfloat16(), cfg_p)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def _inputs(jcfg, b, seed):
    params = jax.tree.map(np.asarray, R.init(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, jcfg.vocab_sizes[f], (b, jcfg.multi_hot))
                    for f in range(jcfg.n_fields)], axis=1).astype(np.int32)
    dense = rng.standard_normal((b, jcfg.n_dense)).astype(np.float32)
    return params, ids, dense


def _hold_forward(jcfg, pcfg, b, seed):
    params, ids, dense = _inputs(jcfg, b, seed)
    jb = {"sparse_ids": jnp.asarray(ids), "dense": jnp.asarray(dense)}
    tb = {"sparse_ids": torch.from_numpy(ids), "dense": torch.from_numpy(dense)}
    tp = convert.recsys_params_from_numpy(params, pcfg, "cpu")
    before = dict(LAUNCHES)
    logit = rs.forward(tp, tb, pcfg)
    scores = rs.serve(tp, tb, pcfg)
    assert LAUNCHES == before, "the CPU path launched a kernel"
    assert logit.shape == (b,) and logit.dtype == torch.float32
    np.testing.assert_allclose(logit.numpy(), np.asarray(R.forward(params, jb, jcfg)),
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(R.serve(params, jb, jcfg)),
                               rtol=0, atol=LOGIT_ATOL)
    assert bool(((scores >= 0) & (scores <= 1)).all())


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
@pytest.mark.parametrize("seed", [0, 3])
def test_forward_and_serve_match_reference_smoke(arch_id, seed):
    jm, pm = PAIRS[arch_id]
    _hold_forward(jm.SMOKE, pm.SMOKE, cb.RECSYS_SMOKE["batch"], seed)


def test_deepfm_full_widths_match_reference():
    """DeepFM at its FULL widths (39 fields, D = 10, MLP 400-400-400) over
    the reduced vocabulary, batch 64."""
    jc = dataclasses.replace(j_deepfm.FULL, vocab_sizes=jcb.criteo_vocab_sizes(39, True))
    pc = dataclasses.replace(deepfm.FULL, vocab_sizes=cb.criteo_vocab_sizes(39, True))
    _hold_forward(jc, pc, 64, 1)


def test_fm_reference_kernel_route_matches():
    """The reference's Pallas route (use_pallas, interpret mode) gives the
    same logits as its jnp route and the port."""
    jc = dataclasses.replace(j_fm.SMOKE, use_pallas=True)
    params, ids, dense = _inputs(jc, 32, 2)
    want = R.forward(params, {"sparse_ids": jnp.asarray(ids), "dense": jnp.asarray(dense)}, jc)
    got = rs.forward(convert.recsys_params_from_numpy(params, fm.SMOKE, "cpu"),
                     {"sparse_ids": torch.from_numpy(ids), "dense": torch.from_numpy(dense)},
                     fm.SMOKE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("n_valid", [None, 300])
def test_score_candidates_ties_match_reference(n_valid):
    """Integer-valued embeddings: every score is exact and many tie; ties
    rank by lower index on both sides."""
    rng = np.random.default_rng(6)
    cand = rng.integers(-2, 3, (512, 4)).astype(np.float32)
    q = np.array([1, -1, 2, 0], np.float32)
    top, idx = R.score_candidates(jnp.asarray(q), jnp.asarray(cand), k=100, n_valid=n_valid)
    got_top, got_idx = rs.score_candidates(torch.from_numpy(q), torch.from_numpy(cand), k=100,
                                           n_valid=n_valid)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_top.numpy(), np.asarray(top))
    assert len(np.unique(np.asarray(top))) < 100, "the data must tie"


@pytest.mark.parametrize("arch_id", sorted(PAIRS))
def test_bind_serve_and_retrieval_smoke(arch_id):
    """The port's ``bind`` as ``tests/test_arch_smoke.py`` drives the
    reference's: seeded init, seeded smoke batch, scores in [0, 1]; the
    retrieval step is exact against brute force."""
    gen = torch.Generator().manual_seed(0)
    bound = steps.bind(arch_id, "serve_p99", reduced=True, device="cpu")
    assert bound.kind == "serve" and bound.device == torch.device("cpu")
    params = bound.init_fn(gen)
    batch = cb.recsys_smoke_batch(gen, bound.cfg, bound.shape, "cpu")
    for name, (shape, dtype) in bound.input_specs.items():
        assert tuple(batch[name].shape) == shape and batch[name].dtype == dtype
    scores = bound.step_fn(params, batch)
    assert scores.shape == (cb.RECSYS_SMOKE["batch"],)
    assert bool(((scores >= 0) & (scores <= 1)).all())

    bound = steps.bind(arch_id, "retrieval_cand", reduced=True, device="cpu")
    batch = cb.recsys_smoke_batch(gen, bound.cfg, bound.shape, "cpu")
    top, idx = bound.step_fn(bound.init_fn(gen), batch)
    assert top.shape == (100,) and idx.shape == (100,)
    assert bool((torch.diff(top) <= 0).all())
    ref = torch.argsort(-(batch["cand_embs"].double() @ batch["query_emb"].double()))[:100]
    assert set(idx.tolist()) == set(ref.tolist())


def test_recsys_batch_and_params_round_trip():
    cfg = wide_deep.SMOKE
    gen = torch.Generator().manual_seed(9)
    batch = recsys_batch(gen, 64, cfg.n_fields, cfg.vocab_sizes, cfg.n_dense, cfg.multi_hot,
                         device="cpu")
    assert batch["sparse_ids"].shape == (64, cfg.n_fields, cfg.multi_hot)
    assert batch["sparse_ids"].dtype == torch.int32
    hi = torch.tensor(cfg.vocab_sizes)[None, :, None]
    assert bool(((batch["sparse_ids"] >= 0) & (batch["sparse_ids"] < hi)).all())
    assert batch["dense"].shape == (64, cfg.n_dense) and batch["labels"].shape == (64,)
    assert set(batch["labels"].unique().tolist()) <= {0.0, 1.0}

    params = rs.init(gen, xdeepfm.SMOKE, "cpu")
    back = convert.recsys_params_from_numpy(convert.recsys_params_to_numpy(params),
                                            xdeepfm.SMOKE, "cpu")
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)))
    # the port's init has the reference's tree and shapes
    ref = R.init(jax.random.PRNGKey(0), j_xdeepfm.SMOKE)[0]
    assert jax.tree.structure(ref) == jax.tree.structure(params)
    assert [tuple(a.shape) for a in jax.tree.leaves(ref)] == \
        [tuple(a.shape) for a in jax.tree.leaves(params)]
    bad = convert.recsys_params_to_numpy(params)
    bad["cin"]["w0"] = bad["cin"]["w0"][:, :-1]
    with pytest.raises(ValueError):
        convert.recsys_params_from_numpy(bad, xdeepfm.SMOKE, "cpu")
    del bad["cin_out"]
    with pytest.raises(ValueError):
        convert.recsys_params_from_numpy(bad, xdeepfm.SMOKE, "cpu")
