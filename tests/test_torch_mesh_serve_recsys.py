"""Port parity: the recsys serving cells on a mesh of gloo CPU ranks
(``bind(mesh=)``: ``serve`` over row-sharded tables with the batch's rows
over ``data``; ``retrieval`` with the candidates over the flat grid and
only each block's top-k crossing) against the reference's mesh result, and
the paper's ANN cells bound with a mesh, which ignore it.

The oracle is the reference's bound ``serve`` step and ``score_candidates``
under jit on a forged 2 x 2 host mesh with ``Auto`` axes
(``tests/_mesh_oracle.py``, one subprocess for every job of this file,
running while the port's ranks run). Params are the reference's ``init``
through ``convert``; ids, dense features and candidates are numpy draws
from a seed.

Tolerances: scores within 1e-6 (the SMOKE configs' own dtypes: each rank
computes its rows as one device does; the row-sharded lookup adds one
nonzero row to zeros); retrieval ids exactly, their scores exactly
(integer-valued embeddings: every product is exact, and many tie).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import recsys as R
from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import leaf_axes
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import recsys as rs

import _mesh_oracle as oracle
import _mesh_workers as workers

torch.set_num_threads(1)

MESH = (2, 2)
SERVE = ("deepfm", "fm", "wide-deep", "xdeepfm")
ATOL = 1e-6
N_CAND, K, N_VALID = 512, 100, 300      # 128 candidates a rank; n_valid inside block 2


def _serve_inputs(arch_id, seed):
    jcfg = rconfigs.get(arch_id).make_config("serve_p99", True)
    params = jax.tree.map(np.asarray, R.init(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.default_rng(seed)
    b = 32
    ids = np.stack([rng.integers(0, jcfg.vocab_sizes[f], (b, jcfg.multi_hot))
                    for f in range(jcfg.n_fields)], axis=1).astype(np.int32)
    dense = rng.standard_normal((b, jcfg.n_dense)).astype(np.float32)
    return params, {"sparse_ids": ids, "dense": dense}


def _candidates():
    """Integer-valued candidates with equal rows on both sides of every
    block edge (ties across ranks) and the best rows among them."""
    rng = np.random.default_rng(7)
    cand = rng.integers(-2, 3, (N_CAND, 4)).astype(np.float32)
    q = np.array([1, -1, 2, 0], np.float32)
    for edge in (128, 256, 384):
        cand[edge - 2:edge + 2] = [2, -2, 2, 1]
    return q, cand


def _mesh(rank):
    return M.Mesh(("data", "model"), dict(zip(("data", "model"), MESH)), "gloo",
                  torch.device("cpu"), rank, {})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the oracle's results, every rank's results, the inputs) by job."""
    tmp = tmp_path_factory.mktemp("mesh_serve_recsys")
    o_jobs, p_jobs, inputs = {}, {}, {}
    for i, arch_id in enumerate(SERVE):
        params, batch = inputs[arch_id] = _serve_inputs(arch_id, i)
        o_jobs[arch_id] = dict(arch=arch_id, shape="serve_p99", cfg={}, mesh=MESH,
                               params=params, serve={"kind": "step", "batch": batch})
        pcfg = configs.get(arch_id).make_config("serve_p99", True)
        p_jobs[arch_id] = dict(family="recsys", arch=arch_id, shape="serve_p99", cfg=pcfg,
                               mesh=MESH,
                               params=convert.recsys_params_from_numpy(params, pcfg, "cpu"),
                               batch={k: torch.from_numpy(v) for k, v in batch.items()})
    q, cand = inputs["retrieval"] = _candidates()
    o_jobs["retrieval"] = dict(arch="deepfm", shape="retrieval_cand", cfg={}, mesh=MESH,
                               params=None, serve={"kind": "step", "batch": {
                                   "query_emb": q, "cand_embs": cand}})
    o_jobs["retrieval_valid"] = dict(arch="deepfm", shape="retrieval_cand", cfg={}, mesh=MESH,
                                     params=None, serve={"kind": "retrieval", "query": q,
                                                         "cand": cand, "k": K,
                                                         "n_valid": N_VALID})
    p_jobs["retrieval"] = dict(family="retrieval", mesh=MESH, query=torch.from_numpy(q),
                               cand=torch.from_numpy(cand), k=K, n_valid=N_VALID)
    wait = oracle.start(list(o_jobs.values()), str(tmp))
    M.spawn(workers.serve_jobs, MESH[0] * MESH[1], (p_jobs, str(tmp)), backend="gloo")
    ranks = {}
    for r in range(MESH[0] * MESH[1]):
        for name, res in torch.load(tmp / f"rank{r}.pt", weights_only=False).items():
            ranks.setdefault(name, {})[r] = res
    return dict(zip(o_jobs, wait())), ranks, p_jobs


@pytest.mark.parametrize("arch_id", SERVE)
def test_serve_matches_the_reference_mesh(runs, arch_id):
    """Every rank gathers the reference's mesh scores; FM and DeepFM call
    ``fm_interact`` once a rank, on the rank's 16 rows; each rank holds its
    blocks of the params (a quarter of the tables)."""
    ref, ranks, p_jobs = runs
    want = ref[arch_id]["out"]
    cfg = p_jobs[arch_id]["cfg"]
    fm = cfg.interaction in ("fm", "fm-2way")
    params = p_jobs[arch_id]["params"]
    whole = sum(t.numel() * t.element_size() for _, t in flatten(params))
    blocks = sum(int(np.prod(sh.block_shape(t.shape, _mesh(0), ax))) * t.element_size()
                 for (_, t), ax in zip(flatten(params), leaf_axes(rs.param_axes(cfg), params)))
    assert blocks < whole
    for r, res in ranks[arch_id].items():
        got = res["scores"].numpy()
        assert got.shape == want.shape == (32,)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert res["fm_rows"] == ([16] if fm else []), (r, res["fm_rows"])
        assert res["param_bytes"] == blocks, r


def test_retrieval_matches_the_reference_mesh(runs):
    """The bound top-100 and ``score_candidates`` with ``n_valid`` inside a
    block: ids and scores exactly the reference's, on every rank; the tied
    rows on both sides of each block edge rank by global id."""
    ref, ranks, _ = runs
    top, ids = ref["retrieval"]["out"]
    vtop, vids = ref["retrieval_valid"]["out"]
    for r, res in ranks["retrieval"].items():
        assert res["rows"] == N_CAND // 4
        assert res["ids"].dtype == torch.int32
        np.testing.assert_array_equal(res["ids"].numpy(), ids)
        np.testing.assert_array_equal(res["top"].numpy(), top)
        np.testing.assert_array_equal(res["valid_ids"].numpy(), vids)
        np.testing.assert_array_equal(res["valid_top"].numpy(), vtop)
    assert list(ids[:16]) == sorted(ids[:16])           # the tied best rows, by global id
    assert int(vids.max()) < N_VALID <= int(ids.max())


@pytest.mark.parametrize("shape", ["build_1m", "search_1m"])
def test_ann_cells_ignore_the_mesh(shape):
    """``rnnd-ann`` binds with any mesh and ignores it, as the reference
    does: no mesh on the bound step, and its result is the unmeshed step's
    bit for bit."""
    mesh = _mesh(1)
    with_mesh = steps.bind("rnnd-ann", shape, reduced=True, mesh=mesh)
    without = steps.bind("rnnd-ann", shape, reduced=True, device="cpu")
    assert with_mesh.mesh is None and with_mesh.kind == without.kind
    assert with_mesh.device == torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(600, 32, generator=gen)
    build = steps.bind("rnnd-ann", "build_1m", reduced=True, device="cpu").step_fn
    g = build({}, {"x": x})
    if shape == "build_1m":
        batch = {"x": x}
    else:
        batch = {"x": x, "neighbors": g.neighbors, "dists": g.dists,
                 "queries": torch.randn(16, 32, generator=gen)}
    got, want = with_mesh.step_fn({}, batch), without.step_fn({}, batch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
