"""Mesh training's substrate on gloo CPU ranks: the collectives' gradients,
a leaf's block of its logical axes, the global norm and the int8 scale on
blocks, checkpoints across meshes, ``launch.train --ranks``, and the dry
run's per-rank bytes on the reference's production meshes.

Exact where the arithmetic is: a block is a slice, a gathered block the
leaf, the collectives' gradients their transposes (checked against
autograd of the same sums on one process), the int8 codes and scales of
blocks those of the whole leaf, a checkpoint's leaves bit for bit, a
restarted mesh run the uninterrupted one bit for bit. The global norm sums
its leaves in another order: within 1e-6 relative.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw, compression

torch.set_num_threads(1)


# ------------------------------------------------------- blocks (one process)
def _shape_mesh(d, m, rank=0):
    return M.Mesh(("data", "model"), {"data": d, "model": m}, "none", torch.device("cpu"),
                  rank, {})


def test_local_blocks_tile_the_leaf_in_row_major_rank_order():
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    axes = ("fsdp", None, "expert_ff")            # dim 0 over (data, model), dim 2 over data
    parts = {}
    for r in range(4):
        mesh = _shape_mesh(2, 2, r)
        blk = sh.local_block(t, mesh, axes)
        assert blk.shape == sh.block_shape(t.shape, mesh, axes) == (2, 6, 2)
        d, m = divmod(r, 2)
        np.testing.assert_array_equal(blk, t[2 * r:2 * r + 2, :, 2 * d:2 * d + 2])
        parts[r] = blk
    assert sh.sharded_axes(_shape_mesh(2, 2), axes) == ("data", "model")
    assert sh.replicated_axes(_shape_mesh(2, 2), ("vocab", None)) == ("data",)


def test_a_dim_that_does_not_split_names_the_leaf():
    with pytest.raises(ValueError, match="wq"):
        sh.local_block(torch.zeros(6, 5), _shape_mesh(2, 2), (None, "fsdp"), "wq")


def test_production_mesh_is_shapes_without_groups():
    mesh = M.make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.groups == {}
    pod = M.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert sh.mesh_axes(pod, "batch") == ("pod", "data")
    assert sh.block_shape((256, 4096), pod, ("batch", None)) == (8, 4096)
    with pytest.raises(KeyError):
        comm.psum(torch.zeros(1), mesh, ("data",))


# --------------------------------------------------------------- on ranks
def _substrate(rank, world, tmp):
    torch.set_num_threads(1)
    mesh = M.make_mesh((2, 2), ("data", "model"), backend="gloo", device="cpu")
    res = {}
    g = torch.Generator().manual_seed(rank)
    # collectives with gradients: d/dx of sum(w * f(x)) with w this rank's weights
    x = torch.randn(4, 3, generator=g, requires_grad=True)
    w = torch.randn(16, 3, generator=g)
    y = comm.all_gather(x, mesh, ("data", "model"))                      # (16, 3)
    res["ag"] = torch.autograd.grad((y * w).sum(), x)[0]
    x2 = torch.randn(8, 3, generator=g, requires_grad=True)
    w2 = torch.randn(2, 3, generator=g)
    res["rs"] = torch.autograd.grad((comm.reduce_scatter(x2, mesh, ("data", "model")) * w2)
                                    .sum(), x2)[0]
    x3 = torch.randn(2, 5, generator=g, requires_grad=True)
    w3 = torch.randn(2, 5, generator=g)
    res["a2a"] = torch.autograd.grad((comm.all_to_all(x3, mesh, ("model",)) * w3).sum(), x3)[0]
    x4 = torch.randn(5, generator=g, requires_grad=True)
    w4 = torch.randn(5, generator=g)
    res["ps"] = torch.autograd.grad((comm.psum(x4, mesh, ("data",)) * w4).sum(), x4)[0]
    res["inputs"] = (x.detach(), w, x2.detach(), w2, x3.detach(), w3, x4.detach(), w4)
    res["calls"] = dict(mesh.stats.calls)

    # blocks of a whole tree: the norm, the int8 scales, the checkpoint
    whole, axes = _tree()
    blocks = sh.tree_local_blocks(whole, mesh, axes)
    res["norm"] = adamw.global_norm(blocks, mesh, axes)
    q, s, r = compression.compress_tree(blocks, None, mesh)
    res["q"] = sh.tree_gather_blocks(q, mesh, axes)
    res["s"] = s
    ckpt.save(os.path.join(tmp, "ck"), 3, blocks, mesh=mesh, axes=axes)
    back = ckpt.restore(os.path.join(tmp, "ck"), 3, blocks, mesh=mesh, axes=axes)
    res["restored_equal"] = all(torch.equal(a, b) for (_, a), (_, b) in
                                zip(flatten(back), flatten(blocks)))
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def _restore_1x2(rank, world, tmp):
    mesh = M.make_mesh((1, 2), ("data", "model"), backend="gloo", device="cpu")
    whole, axes = _tree()
    back = ckpt.restore(os.path.join(tmp, "ck"), 3, whole, mesh=mesh, axes=axes)
    torch.save(sh.tree_gather_blocks(back, mesh, axes), os.path.join(tmp, f"r12_{rank}.pt"))


def _tree():
    g = torch.Generator().manual_seed(7)
    whole = {"emb": torch.randn(8, 4, generator=g), "w": torch.randn(2, 4, 8, generator=g),
             "ln": torch.randn(4, generator=g), "h": torch.randn(4, 8, generator=g).bfloat16()}
    axes = {"emb": ("vocab", None), "w": ("layers", None, "fsdp"), "ln": (None,),
            "h": (None, "vocab")}
    return whole, axes


@pytest.fixture(scope="module")
def substrate(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_sub"))
    M.spawn(_substrate, 4, (tmp,), backend="gloo")
    M.spawn(_restore_1x2, 2, (tmp,), backend="gloo")
    return tmp, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(4)]


def test_collective_gradients_are_their_transposes(substrate):
    """Each rank r differentiates sum(w_r * collective(x)); the gradient a
    rank gets is autograd's of the total on one process."""
    _, res = substrate
    ins = [r["inputs"] for r in res]
    xs = [torch.stack([i[k] for i in ins]).requires_grad_(True) for k in (0, 2, 4, 6)]
    x, x2, x3, x4 = xs
    w, w2, w3, w4 = (torch.stack([i[k] for i in ins]) for k in (1, 3, 5, 7))
    total = (x.reshape(16, 3)[None] * w).sum()                             # all_gather
    total = total + (x2.sum(0).reshape(4, 2, 3) * w2).sum()                # reduce_scatter
    # all_to_all over model: rank (d, m) gets block m of ranks (d, 0), (d, 1)
    for d in range(2):
        for m in range(2):
            got = torch.stack([x3[2 * d + s, m] for s in range(2)])
            total = total + (got * w3[2 * d + m]).sum()
    for r in range(4):                                                     # psum over data
        total = total + (x4[[r % 2, r % 2 + 2]].sum(0) * w4[r]).sum()
    grads = torch.autograd.grad(total, xs)
    for r in range(4):
        for k, name in enumerate(("ag", "rs", "a2a", "ps")):
            torch.testing.assert_close(res[r][name], grads[k][r], rtol=1e-6, atol=1e-6)
        assert res[r]["calls"]["reduce_scatter"] == 2      # all_gather's backward + the call


def test_global_norm_and_int8_scales_on_blocks_are_the_whole_trees(substrate):
    _, res = substrate
    whole, _ = _tree()
    want = adamw.global_norm(whole)
    q, s, _ = compression.compress_tree(whole, None)
    for r in range(4):
        assert abs(float(res[r]["norm"]) - float(want)) <= 1e-6 * float(want)
        for (_, a), (_, b) in zip(flatten(res[r]["q"]), flatten(q)):
            assert torch.equal(a, b)
        for (_, a), (_, b) in zip(flatten(res[r]["s"]), flatten(s)):
            assert torch.equal(a, b)


def test_mesh_checkpoint_is_the_global_layout_and_restores_elsewhere(substrate):
    """Saved on 2 x 2 (rank 0 writes the whole leaves): restored on 2 x 2
    bit for bit, on 1 x 2 and with no mesh as the whole tree."""
    tmp, res = substrate
    whole, _ = _tree()
    assert all(r["restored_equal"] for r in res)
    plain = ckpt.restore(os.path.join(tmp, "ck"), 3, whole, device="cpu")
    assert ckpt.manifest_names(os.path.join(tmp, "ck"), 3) == [n for n, _ in flatten(whole)]
    for (_, a), (_, b) in zip(flatten(plain), flatten(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"r12_{r}.pt"), weights_only=False)
        for (_, a), (_, b) in zip(flatten(got), flatten(whole)):
            assert torch.equal(a, b)


# ------------------------------------------------------------ launch.train
ARGV = ["--arch", "minitron-4b", "--shape", "train_4k", "--reduced", "--device", "cpu",
        "--ranks", "2", "--mesh", "1x2", "--log-every", "100"]


def _leaves(path, step):
    names = ckpt.manifest_names(path, step)
    with np.load(os.path.join(path, f"step_{step:09d}", "shard_00000.npz")) as d:
        return names, [d[f"leaf_{i}"].copy() for i in range(len(names))]


def test_launch_train_ranks_restart_ends_equal_to_an_uninterrupted_run(tmp_path):
    """``--ranks 2 --mesh 1x2`` (minitron's SMOKE config; the card runs
    ``--ranks 4 --mesh 2x2``): 2 steps with a checkpoint each, and a rerun
    from the step-0 commit alone, end in the same checkpoint bit for bit,
    with the same losses."""
    a, b = tmp_path / "a", tmp_path / "b"
    clean = launch_train.run(ARGV + ["--steps", "2", "--ckpt-dir", str(a), "--ckpt-every", "1"])
    b.mkdir()
    os.rename(a / "step_000000000", b / "step_000000000")
    again = launch_train.run(ARGV + ["--steps", "2", "--ckpt-dir", str(b), "--ckpt-every", "1"])
    assert again["first_step"] == 1 and again["losses"] == clean["losses"][1:]
    na, la = _leaves(str(a), 1)
    nb, lb = _leaves(str(b), 1)
    assert na == nb and ".opt.master['embed']['table']" in na
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_launch_train_ranks_arguments():
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "deepfm", "--ranks", "4", "--mesh", "2x3"])
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "deepfm", "--ranks", "4"])
    args = launch_train.parse_args(["--arch", "deepfm", "--ranks", "4", "--mesh", "2x2"])
    assert args.mesh_shape == (2, 2) and args.backend == "gloo"


# ---------------------------------------------------------------- dry run
def test_dryrun_per_rank_bytes_on_the_production_meshes():
    """ogb_products whole on 16 x 16: the edges split 16 ways over data,
    the nodes and the params whole on every device; an LM train cell's
    ZeRO-3 state about 1/256 of the whole."""
    ogb = dryrun.run_cell("dimenet", "ogb_products")
    pr = ogb["per_rank"]["16x16"]
    assert pr["state_bytes"] == ogb["state_bytes"]
    bound = steps.bind("dimenet", "ogb_products", device="meta")
    specs = bound.input_specs
    edges = sum(np.prod(s) * torch.empty(0, dtype=d).element_size()
                for k, (s, d) in specs.items() if k.startswith("edge_"))
    nodes = ogb["batch_bytes"] - edges
    assert pr["batch_bytes"] == nodes + edges // 16
    assert pr["uneven"] == []
    ds = steps.bind("deepseek-moe-16b", "train_4k", device="meta")
    state = ds.init_fn(None)
    got, uneven = dryrun.per_rank_bytes(state, ds.state_axes, M.make_production_mesh())
    assert got < dryrun._nbytes(state) / 100 and uneven == []
    assert "per_rank" in json.dumps(ogb)


# -------------------------------------------------- the MoE's group choice
@pytest.mark.parametrize("grid", [(2, 2), (16, 16), (2, 16, 16)])
def test_moe_groups_and_token_axis_match_the_reference(grid):
    """``_moe_groups`` and ``_tok_axis`` against the reference's on the
    same mesh shapes (a stand-in with the reference's attributes)."""
    import types

    from repro.models import transformer as T
    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.models import transformer as tf
    axes = ("pod", "data", "model")[-len(grid):]
    ref_mesh = types.SimpleNamespace(devices=np.empty(grid), axis_names=axes)
    mesh = M.Mesh(axes, dict(zip(axes, grid)), "none", torch.device("cpu"), 0, {})
    par = tf._par(deepseek_moe_16b.SMOKE, mesh, None)
    for t in (4, 8, 16, 48, 64, 96, 1024, 4096, 8192, 12_288):
        assert tf._moe_groups(t, par) == T._moe_groups(t, ref_mesh), t
        assert tf._tok_axis(t, mesh) == T._tok_axis(t, ref_mesh), t
