"""Port parity: LM training on a mesh of gloo CPU ranks (``bind(mesh=)``,
ZeRO-3 blocks, context-parallel attention, the shard-mapped MoE's
all_to_all and the grouped MoE) against the reference's mesh result.

The oracle is the reference's ``loss_fn`` and bound train step under jit on
a forged host mesh with ``Auto`` axes (``tests/_mesh_oracle.py``, one
subprocess for every job of this file, running while the port's ranks
run). Parameters and the initial train state are the reference's ``init``
through ``convert``; batches are numpy draws from a seed.

Tolerances, each leaf against its largest magnitude:
  * f32 (``compute_dtype=float32``): the loss within 1e-5 relative, the
    gradients and the state after two steps within 1e-4;
  * bf16 (the configs' own dtype): the loss within 3e-2 relative and the
    gradients within 6e-2, the bound of the one-device LM tests
    (``tests/_lm.py``): the blocks are rounded where the reference rounds,
    in other sum orders;
  * the MoE's routing (``top_e``) exactly, its output within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.distributed.sharding import leaf_axes

import _mesh_oracle as oracle
import _mesh_workers as workers

torch.set_num_threads(1)

F32 = {"compute_dtype": "f32"}
JOBS = {
    # ZeRO-3 and context parallelism
    "minitron_1x2": dict(arch="minitron-4b", cfg=F32, mesh=(1, 2), b=2, s=32),
    "minitron_2x1": dict(arch="minitron-4b", cfg=F32, mesh=(2, 1), b=2, s=32),
    "minitron_2x2": dict(arch="minitron-4b", cfg=F32, mesh=(2, 2), b=2, s=32),
    "minitron_bf16_2x2": dict(arch="minitron-4b", cfg={}, mesh=(2, 2), b=2, s=32),
    # the shard-mapped MoE: 2 x 128 tokens on 2 x 2, 64 a shard
    "deepseek_sm_2x2": dict(arch="deepseek-moe-16b", cfg=F32, mesh=(2, 2), b=2, s=128,
                            moe=True),
    # the grouped MoE: 16 tokens a shard, four dispatch groups
    "deepseek_grouped_2x2": dict(arch="deepseek-moe-16b", cfg=F32, mesh=(2, 2), b=2, s=32,
                                 moe=True),
    # GQA MoE, shard-mapped over model only
    "dbrx_sm_1x2": dict(arch="dbrx-132b", cfg=F32, mesh=(1, 2), b=2, s=128),
}


def _batches(job, seed):
    vocab = configs.get(job["arch"]).make_config("train_4k", True).vocab
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        t = rng.integers(0, vocab, (job["b"], job["s"] + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _torch_cfg(arch_id, over):
    cfg = configs.get(arch_id).make_config("train_4k", True)
    if over.get("compute_dtype") == "f32":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the oracle's results, the port's rank-0 results, every rank's
    results) by job."""
    tmp = tmp_path_factory.mktemp("mesh_lm")
    names = list(JOBS)
    o_jobs = []
    for i, name in enumerate(names):
        job = JOBS[name]
        o_jobs.append(dict(arch=job["arch"], shape="train_4k", cfg=job["cfg"], mesh=job["mesh"],
                           seed=i, batches=_batches(job, 100 + i)))
        if job.get("moe"):
            o_jobs[-1]["moe"] = {"y3": np.random.default_rng(200 + i).standard_normal(
                (job["b"], job["s"], 64)).astype(np.float32)}
    wait = oracle.start(o_jobs, str(tmp))
    p_jobs = {}
    for name, o_job in zip(names, o_jobs):
        job = JOBS[name]
        state = oracle.initial_state(job["arch"], "train_4k", job["cfg"], o_job["seed"])
        pcfg = _torch_cfg(job["arch"], job["cfg"])
        p_jobs[name] = dict(
            family="lm", arch=job["arch"], shape="train_4k", cfg=pcfg, mesh=job["mesh"],
            state=convert.train_state_from_numpy(state, pcfg, "cpu"),
            batches=[{k: torch.from_numpy(v) for k, v in b.items()} for b in o_job["batches"]])
        if "moe" in o_job:
            p_jobs[name]["moe"] = {"y3": torch.from_numpy(o_job["moe"]["y3"])}
    ranks = {}
    for world in (2, 4):
        out = tmp / f"w{world}"
        out.mkdir()
        M.spawn(workers.train_jobs, world, (p_jobs, str(out)), backend="gloo")
        for r in range(world):
            for name, res in torch.load(out / f"rank{r}.pt", weights_only=False).items():
                ranks.setdefault(name, {})[r] = res
    ref = dict(zip(names, wait()))
    for name, res in ref.items():
        res["state0"] = p_jobs[name]["state"]
        res["batches"] = p_jobs[name]["batches"]
    return ref, {k: v[0] for k, v in ranks.items()}, ranks


def _close(got, want, tol, what):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    lim = tol * float(np.abs(w).max()) + 1e-30
    err = float(np.abs(g - w).max())
    assert err <= lim, (what, err, lim)


def _tols(name):
    return (3e-2, 6e-2) if "bf16" in name else (1e-5, 1e-4)


@pytest.mark.parametrize("name", list(JOBS))
def test_loss_matches_the_reference_mesh(runs, name):
    ref, port, _ = runs
    tol = _tols(name)[0]
    assert abs(port[name]["loss"] - ref[name]["loss"]) <= tol * abs(ref[name]["loss"])


@pytest.mark.parametrize("name", list(JOBS))
def test_gradients_match_the_reference_mesh(runs, name):
    ref, port, _ = runs
    want = ref[name]["grads"]
    assert set(port[name]["grads"]) == set(want)
    for leaf, g in port[name]["grads"].items():
        _close(g, want[leaf], _tols(name)[1], leaf)


@pytest.mark.parametrize("name", [n for n in JOBS if "bf16" not in n])
def test_two_steps_match_the_reference_mesh(runs, name):
    ref, port, _ = runs
    np.testing.assert_allclose(port[name]["losses"], ref[name]["losses"], rtol=1e-5)
    want = ref[name]["state"]
    assert set(port[name]["state"]) == set(want)
    for leaf, t in port[name]["state"].items():
        if leaf == ".opt.step":
            assert int(t) == int(want[leaf]) == 2
            continue
        _close(t, want[leaf], 1e-4, leaf)


@pytest.mark.parametrize("name", ["deepseek_sm_2x2", "deepseek_grouped_2x2"])
def test_moe_layer_matches_the_reference_mesh(runs, name):
    """Layer 0's MoE on the same activations: the shard-mapped path's
    routing is the reference's exactly; both paths' outputs and aux."""
    ref, port, _ = runs
    got, want = port[name]["moe"], ref[name]["moe"]
    _close(got["y"], want["y"], 1e-5, "y")
    assert abs(got["aux"] - want["aux"]) <= 1e-5 * abs(want["aux"])
    if "top_e" in want:
        np.testing.assert_array_equal(got["top_e"].numpy(), want["top_e"])


def test_mesh_moe_loss_differs_from_the_mesh_free_loss(runs):
    """On 2 x 2 the shard-mapped MoE routes each shard with its own
    capacity: the reference's mesh loss is not the mesh-free loss of the
    same params and batch (the port's one device, which equals the
    reference's one device within 1e-5: tests/test_torch_transformer.py),
    and the port's mesh loss is the reference's mesh loss (above), and
    the port's one device emulating the mesh's shards (``moe_tiles``)
    gives it too."""
    ref, port, _ = runs
    job = ref["deepseek_sm_2x2"]
    cfg = _torch_cfg("deepseek-moe-16b", F32)
    with torch.no_grad():
        free = float(tf.loss_fn(job["state0"].params, job["batches"][0], cfg))
        tiles = float(tf.loss_fn(job["state0"].params, job["batches"][0], cfg,
                                 moe_tiles=(2, 2)))
    assert abs(job["loss"] - free) > 1e-4 * abs(free)
    assert abs(port["deepseek_sm_2x2"]["loss"] - free) > 1e-4 * abs(free)
    assert abs(tiles - job["loss"]) <= 1e-5 * abs(job["loss"])


def test_zero3_rank_holds_its_blocks_of_params_moments_and_master(runs):
    """Each of 4 ranks holds exactly its blocks of the params, ``m``, ``v``
    and the master: the ``fsdp`` and expert leaves a quarter, the vocab
    leaves a half (``vocab``@model), the norms and the router whole; at the
    smoke width the vocab leaves are most of the model, so under half of
    the one-device state."""
    _, _, ranks = runs
    state = oracle.initial_state("deepseek-moe-16b", "train_4k", F32, 4)
    cfg = _torch_cfg("deepseek-moe-16b", F32)
    full = convert.train_state_from_numpy(state, cfg, "cpu")
    one = {"params": full.params, "m": full.opt.m, "v": full.opt.v, "master": full.opt.master}
    mesh = M.Mesh(("data", "model"), {"data": 2, "model": 2}, "gloo", torch.device("cpu"), 0, {})
    for part, tree in one.items():
        whole = fsdp.state_bytes(tree)
        want = sum(int(np.prod(sh.block_shape(t.shape, mesh, ax))) * t.element_size()
                   for (_, t), ax in zip(flatten(tree), leaf_axes(tf.param_axes(cfg), tree)))
        for r in range(4):
            got = ranks["deepseek_sm_2x2"][r]["bytes"][part]
            assert got == want, (part, r, got, want)
        assert want < 0.5 * whole, (part, want, whole)


def test_collectives_of_the_mesh_step_are_counted(runs):
    """Every collective of a step is in ``mesh.stats``: the ZeRO-3 gathers
    and their reduce-scatters, the shard-mapped MoE's all_to_alls, the
    loss' and norm's psums."""
    _, _, ranks = runs
    for r in range(4):
        stats = ranks["deepseek_sm_2x2"][r]["stats"]
        for op in ("all_gather", "reduce_scatter", "all_to_all", "psum"):
            assert stats[op]["calls"] > 0, (r, op)
        assert "all_to_all" not in ranks["minitron_2x2"][r]["stats"]


def test_bind_refuses_a_serving_cell_on_a_mesh():
    """Every cell binds on a mesh, as in the reference; a serving cell whose
    params do not split over the mesh (the SMOKE vocab of 512 over 3
    ``model`` ranks) is refused when its blocks are taken, naming the
    leaf."""
    mesh = M.Mesh(("data", "model"), {"data": 1, "model": 3}, "gloo", torch.device("cpu"), 0, {})
    bound = steps.bind("minitron-4b", "decode_32k", reduced=True, mesh=mesh)
    assert bound.mesh is mesh and bound.kind == "decode"
    with pytest.raises(ValueError, match="embed.*does not split"):
        bound.init_fn(torch.Generator().manual_seed(0))
