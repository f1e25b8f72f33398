"""Port parity of the sharded streaming index and of mesh-bound serving on
gloo CPU ranks, against the reference's single-device updates and serving
session (JAX, CPU).

Groups of 4 and 2 ranks (``tests/_dist_workers.streaming``; the children
import torch and repro_torch alone) run, on an integer corpus (every
distance exact in f32) and from stores the JAX package built:
``StreamingANN(mesh=)`` through insert (which grows the store), delete,
insert and compact, under l2 (with int8 codes in an exact code space) and
ip, ``delete_fanout`` chosen so the affected rows' budget does not divide
by the ranks; every rank's store after every op equals the reference's
single-device store bit for bit. The store saved at D = 4 restores at
D = 2 and with no mesh. A ``ServingFrontend`` session under a manual clock
(the one of ``tests/test_torch_serving.py``) served query-sharded and
corpus-sharded returns the reference's single-device results, telemetry and
final store. Inserts seed through dense visited on both sides, as the
single-device parity tests do: which of two ids racing for one hash slot
wins differs between XLA and PyTorch. The serving search is dense too.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
from repro import quant as RQ
from repro.core import graph as RG
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.serving import admission as RA
from repro.serving import frontend as RF
from repro.serving import writer as RW
from repro.streaming import StreamingANN as RStreamingANN
from repro.streaming import store as RST
from repro.streaming import updates as RU
from repro_torch import convert
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.serving import AdmissionConfig, ServingConfig, WriterConfig
from repro_torch.streaming import StreamingANN, StreamingConfig

torch.set_num_threads(1)

N0, DIM = 500, 16
BUILD = dict(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128)
KNOBS = dict(seed_l=32, seed_k=12, seed_iters=64, batch_k=4, sweeps=2, splice_k=6,
             delete_fanout=7)
CASES = ("l2", "ip")
# insert 100 (the store grows to 1024 rows), delete 90 (630 affected rows at
# most: not a multiple of 4), insert 60, compact
OPS = (("insert", slice(500, 600)), ("delete", np.arange(30, 120)),
       ("insert", slice(600, 660)), ("compact", None))
ADM = dict(tile_lanes=8, deadline_s=0.05)


def _cfgs(metric):
    return (RU.StreamingConfig(build=RRD.RNNDescentConfig(**BUILD, metric=metric), **KNOBS),
            StreamingConfig(build=rd.RNNDescentConfig(**BUILD, metric=metric), **KNOBS))


def _dense_seeding(mp):
    orig = RU.StreamingConfig.seed_search_cfg
    mp.setattr(RU.StreamingConfig, "seed_search_cfg",
               lambda self: dataclasses.replace(orig(self), visited="dense"))


def _ref_leaves(st) -> list:
    """The reference store's leaves in the port's flatten order, dists as
    the reference's uint32 keys."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(st)[0]:
        a = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        out.append((name, np.asarray(RG.dist_key(leaf)) if name.endswith("dists") else a))
    return out


def _same_store(port_leaves, ref_leaves, what):
    assert [n for n, _ in port_leaves] == [n for n, _ in ref_leaves], what
    for (name, t), (_, want) in zip(port_leaves, ref_leaves):
        got = convert.key_to_reference(G.dist_key(t)) if name.endswith("dists") else t.numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def reference():
    """The stores, ops and the reference's single-device results: each
    case's store after each op with the op's output, and the serving
    session."""
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (700, DIM)).astype(np.float32)
    q = rng.integers(-8, 9, (60, DIM)).astype(np.float32)
    cases, ref = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _dense_seeding(mp)
        for metric in CASES:
            rcfg, cfg = _cfgs(metric)
            g = RRD.build(jnp.asarray(x[:N0]), rcfg.build, jax.random.PRNGKey(1))
            qx = None
            if metric == "l2":      # an exact int8 code space: scale 1/2, zero 0
                qx = RQ.QuantizedCorpus(codes=jnp.asarray((2 * x[:N0]).astype(np.int8)),
                                        scale=jnp.full((DIM,), 0.5, jnp.float32),
                                        zero=jnp.zeros((DIM,), jnp.float32))
            rst = RST.from_built(jnp.asarray(x[:N0]), g, qx=qx)
            ops = [(op, x[arg] if op == "insert" else arg) for op, arg in OPS]
            cases[metric] = (convert.store_from_numpy(rst, device="cpu"), cfg, ops)
            rann = RStreamingANN(store=rst, cfg=rcfg)
            for i, (op, arg) in enumerate(ops):
                out = rann.compact() if op == "compact" else getattr(rann, op)(arg)
                ref[metric, i] = (_ref_leaves(rann.store), np.asarray(out))
        # the serving session (tests/test_torch_serving.py's) on the l2 store
        rcfg, cfg = _cfgs("l2")
        g = RRD.build(jnp.asarray(x[:N0]), rcfg.build, jax.random.PRNGKey(1))
        rst = RST.grow(RST.from_built(jnp.asarray(x[:N0]), g), 600)
        dense = dict(l=32, k=16, max_iters=96, topk=10, visited="dense")
        rscfg = RF.ServingConfig(admission=RA.AdmissionConfig(**ADM),
                                 search=RS.SearchConfig(**dense),
                                 writer=RW.WriterConfig(insert_batch=4, delete_batch=4))
        rann = RStreamingANN(store=rst, cfg=rcfg)
        ref["session"] = (W.replay_session(RF.ServingFrontend, rann, rscfg, q, x[N0:]),
                          _ref_leaves(rann.store))
    scfg = ServingConfig(admission=AdmissionConfig(**ADM), search=S.SearchConfig(**dense),
                         writer=WriterConfig(insert_batch=4, delete_batch=4))
    session = (convert.store_from_numpy(rst, device="cpu"), cfg, scfg, q, x[N0:])
    return cases, session, ref


@pytest.fixture(scope="module")
def ckpt_dir():
    with tempfile.TemporaryDirectory() as d:
        yield d


@pytest.fixture(scope="module")
def ranks(reference, ckpt_dir):
    """world -> the ranks' results: D = 4 saves the l2 case's last store,
    D = 2 restores it."""
    cases, session, _ = reference
    return {4: W.run(W.streaming, 4, cases, session, ckpt_dir, None),
            2: W.run(W.streaming, 2, cases, session, None, ckpt_dir)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_updates_match_reference(ranks, reference, world, case):
    """Every rank's store after each op (insert, delete, insert, compact),
    and the op's output (slots, the tombstoned-now mask, the remap), equal
    the reference's single device's."""
    _, _, ref = reference
    for rank, res in enumerate(ranks[world]):
        # the frontier exchange ran its ring, rows were gathered, the
        # corpus-sharded session's beam steps went through all_to_all
        assert {"ppermute", "all_gather", "all_to_all", "broadcast"} <= set(res["stats"])
        for i, (op, _) in enumerate(OPS):
            leaves, out = res[case, i]
            want_leaves, want_out = ref[case, i]
            _same_store(leaves, want_leaves, f"D = {world} rank {rank} {case} op {i} ({op})")
            np.testing.assert_array_equal(np.asarray(out), want_out)


def test_store_saved_at_four_restores_at_two_and_none(ranks, reference, ckpt_dir):
    cases, _, ref = reference
    want = ref["l2", len(OPS) - 1][0]
    for res in ranks[2]:
        _same_store(res["restored"], want, "restored at D = 2")
    ann = StreamingANN.restore(ckpt_dir, cases["l2"][1], device="cpu")
    _same_store(W.store_leaves(ann.store), want, "restored with no mesh")
    assert ann.mesh is None and ann.store.x.device == torch.device("cpu")


@pytest.mark.parametrize("shard_mode", ["queries", "corpus"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_session_matches_reference(ranks, reference, world, shard_mode):
    """Rank 0's results and telemetry equal the reference's single-device
    session bit for bit; every rank ends on the reference's store."""
    _, _, ref = reference
    (want, want_summary), want_store = ref["session"]
    (got, summary), _ = ranks[world][0]["session", shard_mode]
    assert len(got) == len(want) == 60
    for i, ((ids, d), (rids, rd_)) in enumerate(zip(got, want)):
        assert ids.dtype == rids.dtype and np.array_equal(ids, rids), i
        assert np.array_equal(d.view(np.uint32), rd_.view(np.uint32)), i
    for key in ("completed", "tiles", "occupancy_hist", "queue_depth_hist", "staleness_max",
                "write_commits", "rows_written", "latency_ms", "deadline_hit_rate"):
        assert summary[key] == want_summary[key], key
    for rank, res in enumerate(ranks[world]):
        out, leaves = res["session", shard_mode]
        assert (out is None) == (rank > 0)
        _same_store(leaves, want_store, f"session D = {world} rank {rank}")
