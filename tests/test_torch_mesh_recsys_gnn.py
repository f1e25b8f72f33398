"""Port parity: recsys (row-sharded tables) and DimeNet (edges over data,
the factorized node buffer's width over model, triplets over the grid)
training on a mesh of gloo CPU ranks, against the reference's mesh result
(``tests/_mesh_oracle.py``; the initial train state is the reference's
``init`` through ``convert``, batches the cells' smoke batches drawn from a
seed).

Tolerances, each leaf against its largest magnitude, at
``compute_dtype=float32``: the loss within 1e-5 relative, the gradients and
the state after two steps within 1e-4, except the recsys deep tower (its
MLP and the dense projection that feeds it), which is bf16 in both packages whatever ``compute_dtype`` says: each rank rounds
its rows' partial weight gradient to bf16 and the ranks' partials are
summed, where the reference rounds in its own sum order, so its gradients
are held within 2e-2. The tables' gradients carry the tower's bf16
cotangent, which the reference's partitioned program rounds elsewhere than
its single device (the port's mesh step is its single device's bit for bit
at 1 x 2; the reference's differ by 2.0e-3 of the table's largest
gradient, measured here): within 1e-2. The moments of these leaves within
2e-2, their parameters and masters within 2 x the summed learning rate
(Adam normalises rounding noise into an update of up to lr a step).
Ranks that differ only in ``model`` repeat the same
rows: a gradient on 2 x 2 equals the one on 2 x 1 within 1e-6 (counted
twice it would be double).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import base as cb
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import recsys as rs

import _mesh_oracle as oracle
import _mesh_workers as workers

torch.set_num_threads(1)

F32 = {"compute_dtype": "f32"}
JOBS = {
    "deepfm_1x2": dict(arch="deepfm", shape="train_batch", mesh=(1, 2)),
    "deepfm_2x1": dict(arch="deepfm", shape="train_batch", mesh=(2, 1)),
    "deepfm_2x2": dict(arch="deepfm", shape="train_batch", mesh=(2, 2)),
    "dimenet_minibatch_2x1": dict(arch="dimenet", shape="minibatch_lg", mesh=(2, 1)),
    "dimenet_minibatch_2x2": dict(arch="dimenet", shape="minibatch_lg", mesh=(2, 2)),
    "dimenet_molecule_2x2": dict(arch="dimenet", shape="molecule", mesh=(2, 2)),
    "dimenet_full_graph_1x2": dict(arch="dimenet", shape="full_graph_sm", mesh=(1, 2)),
}
SAME = [("deepfm_2x2", "deepfm_2x1"), ("dimenet_minibatch_2x2", "dimenet_minibatch_2x1")]


def _cfg(job):
    cfg = configs.get(job["arch"]).make_config(job["shape"], True)
    return dataclasses.replace(cfg, compute_dtype=torch.float32)


def _batches(job, seed):
    arch = configs.get(job["arch"])
    cfg = _cfg(job)
    shape = arch.shape(job["shape"])
    return [{k: v.numpy() for k, v in cb.smoke_batch(arch.family)(
        torch.Generator().manual_seed(seed + i), cfg, shape, "cpu").items()} for i in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_rg")
    names = list(JOBS)
    # the pairs of SAME share their seeds
    seeds = {n: i for i, n in enumerate(names)}
    for a, b in SAME:
        seeds[a] = seeds[b]
    o_jobs = [dict(arch=JOBS[n]["arch"], shape=JOBS[n]["shape"], cfg=F32, mesh=JOBS[n]["mesh"],
                   seed=seeds[n], batches=_batches(JOBS[n], 100 + 10 * seeds[n]))
              for n in names]
    wait = oracle.start(o_jobs, str(tmp))
    p_jobs = {}
    for name, o_job in zip(names, o_jobs):
        job = JOBS[name]
        state = oracle.initial_state(job["arch"], job["shape"], F32, o_job["seed"])
        pcfg = _cfg(job)
        p_jobs[name] = dict(
            family=configs.get(job["arch"]).family, arch=job["arch"], shape=job["shape"],
            cfg=pcfg, mesh=job["mesh"], state=convert.train_state_from_numpy(state, pcfg, "cpu"),
            batches=[{k: torch.from_numpy(v) for k, v in b.items()} for b in o_job["batches"]])
    ranks = {}
    for world in (2, 4):
        out = tmp / f"w{world}"
        out.mkdir()
        M.spawn(workers.train_jobs, world, (p_jobs, str(out)), backend="gloo")
        for r in range(world):
            for name, res in torch.load(out / f"rank{r}.pt", weights_only=False).items():
                ranks.setdefault(name, {})[r] = res
    ref = dict(zip(names, wait()))
    return ref, {k: v[0] for k, v in ranks.items()}, ranks


def _err(got, want):
    g = got.detach().double().numpy()
    w = np.asarray(want, dtype=np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max()), float(np.abs(w).max())


def _deep(leaf):
    return "['mlp']" in leaf or "['dense_proj']" in leaf


def _noisy(leaf):
    """A recsys leaf whose gradient carries the bf16 tower's rounding."""
    return _deep(leaf) or "['table']" in leaf or "['wide']" in leaf


def _grad_tol(leaf):
    return 2e-2 if _deep(leaf) else 1e-2 if _noisy(leaf) else 1e-4


@pytest.mark.parametrize("name", list(JOBS))
def test_loss_matches_the_reference_mesh(runs, name):
    ref, port, _ = runs
    assert abs(port[name]["loss"] - ref[name]["loss"]) <= 1e-5 * abs(ref[name]["loss"])


@pytest.mark.parametrize("name", list(JOBS))
def test_gradients_match_the_reference_mesh(runs, name):
    ref, port, _ = runs
    want = ref[name]["grads"]
    assert set(port[name]["grads"]) == set(want)
    for leaf, g in port[name]["grads"].items():
        err, scale = _err(g, want[leaf])
        assert err <= _grad_tol(leaf) * scale + 1e-30, (leaf, err, scale)


@pytest.mark.parametrize("name", list(JOBS))
def test_two_steps_match_the_reference_mesh(runs, name):
    ref, port, _ = runs
    np.testing.assert_allclose(port[name]["losses"], ref[name]["losses"], rtol=1e-5)
    want = ref[name]["state"]
    assert set(port[name]["state"]) == set(want)
    lr_sum = float(sum(steps.OPT_CFG.lr * min(1.0, s / steps.OPT_CFG.warmup_steps)
                       for s in (1, 2)))
    for leaf, t in port[name]["state"].items():
        if leaf == ".opt.step":
            assert int(t) == int(want[leaf]) == 2
            continue
        err, scale = _err(t, want[leaf])
        if _noisy(leaf) and leaf.startswith((".params", ".opt.master")):
            assert err <= 2 * lr_sum, (leaf, err)
        else:
            tol = 2e-2 if _noisy(leaf) else 1e-4
            assert err <= tol * scale + 1e-30, (leaf, err, scale)


@pytest.mark.parametrize("pair", SAME, ids=[a for a, _ in SAME])
def test_model_ranks_do_not_count_a_gradient_twice(runs, pair):
    """2 x 2 and 2 x 1 split the rows (recsys) or edges (DimeNet) over the
    same two data ranks; on 2 x 2 each row is computed by two model ranks,
    whose duplicate contributions must not both be added."""
    _, port, _ = runs
    a, b = port[pair[0]], port[pair[1]]
    assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"])
    for leaf, g in a["grads"].items():
        err, scale = _err(g, b["grads"][leaf].numpy())
        assert err <= 1e-6 * scale + 1e-30, (leaf, err, scale)


def test_recsys_tables_are_row_blocks_and_the_rest_is_whole(runs):
    """Each of 4 ranks holds a quarter of ``table`` and ``wide`` (and of
    their moments) and the deep tower whole."""
    _, _, ranks = runs
    cfg = _cfg(JOBS["deepfm_2x2"])
    whole = rs.init(torch.Generator().manual_seed(0), cfg, "cpu")
    rows = sum(whole[k].numel() * 4 for k in ("table", "wide"))
    rest = sum(t.numel() * 4 for name, t in flatten(whole)
               if not name.startswith(("['table']", "['wide']")))
    for r in range(4):
        got = ranks["deepfm_2x2"][r]["bytes"]
        for part in ("params", "m", "v"):
            assert got[part] == rows // 4 + rest, (r, part, got[part], rows // 4 + rest)


def test_row_sharded_lookup_collectives_are_counted(runs):
    """The DeepFM step's collectives: the ids gathered over data, the
    looked-up rows reduce-scattered back and summed over model, the
    replicated leaves' gradients summed."""
    _, _, ranks = runs
    for r in range(4):
        stats = ranks["deepfm_2x2"][r]["stats"]
        for op in ("all_gather", "reduce_scatter", "psum"):
            assert stats[op]["calls"] > 0, (r, op)
