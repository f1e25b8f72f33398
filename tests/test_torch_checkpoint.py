"""Port parity: the checkpoint layer against the reference's
(``repro.checkpoint``). A tree saved by either package restores in the
other leaf for leaf: the manifests (step, keystr names, shapes, dtypes) are
equal, and so is every array, bit for bit. The trees are streaming stores
(plain, with int8 codes, with PQ codes, with a compaction remap) and a
generic nest of dicts, lists, tuples and None. Also: keep-k GC, an
uncommitted ``.tmp`` directory, and the async flush, which must write the
values the tree held when save returned.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as RC
from repro import quant as RQ
from repro.core import rnn_descent as RRD
from repro.streaming import StreamingANN as RStreamingANN
from repro.streaming import store as RST
from repro.streaming import updates as RU
from repro_torch import checkpoint as C
from repro_torch import convert
from repro_torch.core import graph as G
from repro_torch.streaming import StreamingANN
from repro_torch.streaming import store as ST

torch.set_num_threads(1)

BUILD = dict(s=8, r=12, t1=2, t2=2, capacity=16, chunk=128)


@pytest.fixture(scope="module")
def ref_stores():
    """Reference stores: plain, int8- and PQ-coded, and compacted (remap)."""
    x = np.random.default_rng(0).integers(-8, 9, (300, 16)).astype(np.float32)
    cfg = RRD.RNNDescentConfig(**BUILD)
    g = RRD.build(jnp.asarray(x), cfg, jax.random.PRNGKey(1))
    st = RST.from_built(jnp.asarray(x), g)
    st = RU.delete(st, np.arange(0, 40), RU.StreamingConfig(build=cfg, seed_k=8, seed_l=16))
    return {
        "plain": st,
        "int8": RST.quantize_store(st, RQ.Quantization(mode="int8")),
        "pq": RST.quantize_store(st, RQ.Quantization(mode="pq", m=4, pq_iters=2)),
        "remap": RST.compact(st)[0],
    }


def _same_leaves(a, b):
    fa, fb = C.checkpoint.flatten(a), C.checkpoint.flatten(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, la), (_, lb) in zip(fa, fb):
        na = la.numpy() if isinstance(la, torch.Tensor) else np.asarray(la)
        nb = lb.numpy() if isinstance(lb, torch.Tensor) else np.asarray(lb)
        assert na.dtype == nb.dtype and na.shape == nb.shape, name
        assert np.array_equal(na, nb), name


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["plain", "int8", "pq", "remap"])
def test_store_checkpoints_cross_between_packages(ref_stores, kind, tmp_path):
    ref = ref_stores[kind]
    port = convert.store_from_numpy(ref, device="cpu")
    RC.save(str(tmp_path / "ref"), 7, ref)
    C.save(str(tmp_path / "port"), 7, port)
    m_ref, m_port = _manifest(tmp_path / "ref", 7), _manifest(tmp_path / "port", 7)
    assert m_port == m_ref
    assert ".graph.neighbors" in m_port["names"] and m_port["dtypes"][m_port["names"].index(
        ".epoch")] == "int32"
    # the port restores the reference's checkpoint, and the reverse
    back = C.restore(str(tmp_path / "ref"), 7, port, device="cpu")
    assert isinstance(back, ST.Store) and isinstance(back.graph, G.Graph)
    _same_leaves(back, port)
    _same_leaves(RC.restore(str(tmp_path / "port"), 7, ref), ref)
    # the indexes' own restore probes the manifest for the optional subtrees
    ann = StreamingANN.restore(str(tmp_path / "ref"), device="cpu")
    _same_leaves(ann.store, port)
    rann = RStreamingANN.restore(str(tmp_path / "port"))
    _same_leaves(rann.store, ref)


def test_generic_tree_names_match_keystr(tmp_path):
    tree = {"b": [np.arange(3, dtype=np.int32), (np.ones((2, 2), np.float32), None)],
            "a": {"z": np.int32(5), "y": np.zeros(4, np.uint8)}, "c": None}
    ref = [jax.tree_util.keystr(kp) for kp, _ in
           jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [n for n, _ in C.checkpoint.flatten(tree)] == ref
    C.save(str(tmp_path / "p"), 0, tree)
    RC.save(str(tmp_path / "r"), 0, tree)
    assert _manifest(tmp_path / "p", 0) == _manifest(tmp_path / "r", 0)
    back = C.restore(str(tmp_path / "r"), 0, tree, device="cpu")
    assert back["c"] is None and back["b"][1][1] is None
    _same_leaves(back, tree)
    with pytest.raises(ValueError, match="leaves"):
        C.restore(str(tmp_path / "r"), 0, {"only": 0}, device="cpu")
    # a bfloat16 leaf saves in the reference's layout (it raised before)
    C.save(str(tmp_path / "p"), 1, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert _manifest(tmp_path / "p", 1)["dtypes"] == ["bfloat16"]


def test_keep_k_gc_and_uncommitted_tmp(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_000000099.tmp"))      # a crash mid-write
    assert C.committed_steps(d) == [] and C.latest_step(d) is None
    for s in range(1, 6):
        C.save(d, s, {"v": torch.full((3,), s)}, keep=2)
    assert C.committed_steps(d) == [4, 5] and C.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_000000004", "step_000000005"]
    assert C.manifest_names(d, 5) == ["['v']"]
    assert int(C.restore(d, 4, {"v": 0}, device="cpu")["v"][0]) == 4
    assert C.committed_steps(str(tmp_path / "missing")) == []


def test_async_flush_writes_the_values_at_save(tmp_path):
    d = str(tmp_path)
    t = torch.arange(1000, dtype=torch.int32)
    th = C.save(d, 3, {"t": t}, async_flush=True)
    t.zero_()                             # the caller reuses its tensor at once
    th.join(timeout=60)
    assert not th.is_alive()
    back = C.restore(d, 3, {"t": 0}, device="cpu")["t"]
    assert torch.equal(back, torch.arange(1000, dtype=torch.int32))
    assert C.save(d, 4, {"t": t}) is None


# ------------------------------------------------------------ bfloat16 leaves
def test_bf16_leaf_round_trip(tmp_path):
    """A bfloat16 leaf is saved as the reference saves one (its 2-byte
    payload as ``|V2``, manifest dtype ``"bfloat16"``) and restored as
    bfloat16, bit for bit."""
    t = {"w": torch.randn(5, 7).bfloat16(), "f": torch.arange(3.0), "i": torch.arange(4)}
    C.save(str(tmp_path), 2, t)
    with open(tmp_path / "step_000000002" / "manifest.json") as f:
        man = json.load(f)
    assert man["dtypes"] == ["float32", "int64", "bfloat16"]
    back = C.restore(str(tmp_path), 2, {"w": 0, "f": 0, "i": 0}, device="cpu")
    assert back["w"].dtype == torch.bfloat16
    for k in t:
        assert torch.equal(back[k], t[k])


def _lm_state():
    from repro.configs import minitron_4b as j_min
    from repro.launch import steps as rsteps
    from repro import configs as rconfigs
    rb = rsteps.bind(rconfigs.get("minitron-4b"), "train_4k", reduced=True)
    return j_min.SMOKE, rb.init_fn(jax.random.PRNGKey(0))


def test_port_restores_a_reference_lm_train_state(tmp_path):
    """The reference's LM TrainState (bf16 layers, f32 master) saved by the
    reference restores in the port to the same bits."""
    from repro_torch.configs import minitron_4b
    from repro_torch.launch import steps
    _, rstate = _lm_state()
    RC.save(str(tmp_path), 0, rstate)
    like = steps.bind("minitron-4b", "train_4k", reduced=True, device="cpu").init_fn(
        torch.Generator().manual_seed(0))
    got = C.restore(str(tmp_path), 0, like, device="cpu")
    want = convert.train_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                          minitron_4b.SMOKE, "cpu")
    assert got.params["layers"]["wq"].dtype == torch.bfloat16
    pairs_g, pairs_w = C.checkpoint.flatten(got), C.checkpoint.flatten(want)
    names = [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(rstate)[0]]
    assert [n for n, _ in pairs_g] == [n for n, _ in pairs_w] == names
    for (_, a), (_, b) in zip(pairs_g, pairs_w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_reads_a_port_lm_train_state_as_its_own(tmp_path):
    """The reference's ``np.load`` of a port-written file gives the bytes it
    gives for its own file of the same state (bf16 leaves as ``|V2``)."""
    from repro_torch.configs import minitron_4b
    _, rstate = _lm_state()
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                           minitron_4b.SMOKE, "cpu")
    RC.save(str(tmp_path / "ref"), 0, rstate)
    C.save(str(tmp_path / "port"), 0, state)
    mans = [json.load(open(tmp_path / d / "step_000000000" / "manifest.json"))
            for d in ("ref", "port")]
    assert mans[0] == mans[1]
    for i in range(len(mans[0]["names"])):
        a, b = (np.load(tmp_path / d / "step_000000000" / "shard_00000.npz")[f"leaf_{i}"]
                for d in ("ref", "port"))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
