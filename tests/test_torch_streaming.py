"""Port parity: the streaming index (store, batched insert and delete,
compact) against the reference's (``repro.streaming``, JAX, CPU), and the
reference's streaming properties held on the port.

Bit for bit on an integer corpus, from a store the JAX package built: every
distance is exact, so x, adjacency ids, distances (through their bits),
flags, masks, epochs and slots must be equal. The seeding search of an
insert is hashed by default, and which of two ids racing for one hash slot
wins differs between XLA and PyTorch, so the insert is held two ways: the
reference's own seeding candidates fed into the port's graft, and a whole
insert whose seeding search runs dense-visited on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as RQ
from repro.core import graph as RG
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.streaming import store as RST
from repro.streaming import updates as RU
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core import eval as E
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
from repro_torch.streaming import StreamingANN, StreamingConfig
from repro_torch.streaming import store as ST
from repro_torch.streaming import updates as U

torch.set_num_threads(1)

BUILD = dict(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128)
KNOBS = dict(seed_l=32, seed_k=12, seed_iters=64, batch_k=4, sweeps=2, splice_k=6)
RCFG = RU.StreamingConfig(build=RRD.RNNDescentConfig(**BUILD), **KNOBS)
CFG = StreamingConfig(build=rd.RNNDescentConfig(**BUILD), **KNOBS)
SCFG = S.SearchConfig(l=32, k=16, max_iters=96, topk=10)


def _port(st):
    return convert.store_from_numpy(st, device="cpu")


def _same(ref, port):
    """Reference store == port store, bit for bit (dists through dist_key)."""
    np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(port.graph.neighbors.numpy(),
                                  np.asarray(ref.graph.neighbors))
    np.testing.assert_array_equal(convert.key_to_reference(G.dist_key(port.graph.dists)),
                                  np.asarray(RG.dist_key(ref.graph.dists)))
    np.testing.assert_array_equal(port.graph.flags.numpy(), np.asarray(ref.graph.flags))
    np.testing.assert_array_equal(port.occupied.numpy(), np.asarray(ref.occupied))
    np.testing.assert_array_equal(port.tombstone.numpy(), np.asarray(ref.tombstone))
    assert int(port.epoch) == int(ref.epoch) and port.epoch.dtype == torch.int32
    assert (port.qx is None) == (ref.qx is None)
    if ref.qx is not None:
        for a, b in zip(port.qx, ref.qx):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (port.remap is None) == (ref.remap is None)
    if ref.remap is not None:
        np.testing.assert_array_equal(port.remap.numpy(), np.asarray(ref.remap))


@pytest.fixture(scope="module")
def int_store():
    """An integer corpus (700 x 16) and the JAX package's store over its
    first 500 rows, with and without int8 codes (an exact code space)."""
    x = np.random.default_rng(0).integers(-8, 9, (700, 16)).astype(np.float32)
    g = RRD.build(jnp.asarray(x[:500]), RCFG.build, jax.random.PRNGKey(1))
    st = RST.from_built(jnp.asarray(x[:500]), g)
    codes = RQ.QuantizedCorpus(codes=jnp.asarray((2 * x[:500]).astype(np.int8)),
                               scale=jnp.full((16,), 0.5, jnp.float32),
                               zero=jnp.zeros((16,), jnp.float32))
    return x, g, st, RST.from_built(jnp.asarray(x[:500]), g, qx=codes)


def test_from_built_grow_compact_match_reference(int_store):
    x, g, st, st_q = int_store
    pg = convert.graph_from_numpy(*map(np.asarray, g), device="cpu")
    xt = torch.from_numpy(x[:500])
    _same(st, ST.from_built(xt, pg))
    _same(RST.from_built(jnp.asarray(x[:500]), g, capacity=700),
          ST.from_built(xt, pg, capacity=700))
    _same(st_q, ST.from_built(xt, pg, qx=_port(st_q).qx._replace(
        codes=_port(st_q).qx.codes[:500])))
    for cap in (100, 600, 1500):
        _same(RST.grow(st_q, cap), ST.grow(_port(st_q), cap))
    assert ST.grow(_port(st), 100).capacity == 512 and ST.next_capacity(500) == 512
    # compact after a delete (and of the compacted store again: remap kept)
    dead = RU.delete(st_q, np.arange(30, 140), RCFG)
    ref, rremap = RST.compact(dead)
    port, premap = ST.compact(_port(dead))
    np.testing.assert_array_equal(premap, rremap)
    _same(ref, port)
    _same(RST.grow(ref, 2000), ST.grow(port, 2000))
    p = _port(st)
    assert (ST.live_count(p), ST.occupied_count(p), ST.free_count(p)) == (500, 500, 12)
    with pytest.raises(ValueError, match="rows"):
        ST.from_built(xt[:10], pg)


@pytest.mark.parametrize("seeding", ["reference candidates", "dense"])
def test_insert_and_delete_match_reference(int_store, seeding, monkeypatch):
    """One insert of 100 points into the JAX package's store (grown to
    capacity 1024, int8 codes updated in the frozen code space), then one
    delete of 90 rows, bit for bit."""
    x, _, _, st_q = int_store
    rst = RST.grow(st_q, 700)
    pst = _port(rst)
    new = x[500:600]
    if seeding == "dense":
        for mod in (RU, U):
            orig = mod.StreamingConfig.seed_search_cfg
            monkeypatch.setattr(mod.StreamingConfig, "seed_search_cfg",
                                lambda self, _o=orig: dataclasses.replace(_o(self),
                                                                          visited="dense"))
        r1, rslots = RU.insert(rst, new, RCFG)
        p1, pslots = U.insert(pst, new, CFG)
        np.testing.assert_array_equal(pslots, rslots)
    else:
        valid = RST.active_mask(rst)
        ep = RS.default_entry_point(rst.x, "l2", valid=valid)
        cand, cd = RS.search_tiled(rst.x, rst.graph, jnp.asarray(new), ep,
                                   RCFG.seed_search_cfg(), tile_b=100, valid=valid)
        slots = np.arange(500, 600, dtype=np.int32)
        f_pad = 100 * (1 + KNOBS["seed_k"])
        rx, rg, rocc = RU._graft(rst.x, rst.graph, rst.occupied, jnp.asarray(new),
                                 jnp.asarray(slots), cand, cd, RCFG, None, f_pad)
        px, pg, pocc = U._graft(pst.x, pst.graph, pst.occupied, torch.from_numpy(new),
                                torch.from_numpy(slots), torch.from_numpy(np.array(cand)),
                                torch.from_numpy(np.array(cd)), CFG, f_pad)
        r1, p1 = (rst._replace(x=rx, graph=rg, occupied=rocc),
                  pst._replace(x=px, graph=pg, occupied=pocc))
    _same(r1, p1)
    _same(rst, pst)                        # the input store is untouched
    r2 = RU.delete(r1, np.arange(50, 140), RCFG)
    p2 = U.delete(p1, np.arange(50, 140), CFG)
    _same(r2, p2)


def test_delete_over_budget_matches_reference(int_store):
    """A repair budget smaller than the affected rows (delete_fanout = 1):
    only the first affected rows, by row id, are repaired, the rest keep
    their edges to the tombstones; bit for bit on a grown store."""
    _, _, st, _ = int_store
    rst = RST.grow(st, 700)
    dead = np.arange(40, 60)
    nb = np.asarray(rst.graph.neighbors)
    aff = (np.isin(nb, dead).any(axis=1) & np.asarray(rst.occupied)
           & ~np.isin(np.arange(rst.capacity), dead)).sum()
    assert aff > dead.size                 # take < aff: the budget truncates
    rcfg = dataclasses.replace(RCFG, delete_fanout=1)
    cfg = dataclasses.replace(CFG, delete_fanout=1)
    _same(RU.delete(rst, dead, rcfg), U.delete(_port(rst), dead, cfg))


def test_row_ids_guard_matches_reference():
    """Frontier tables: table row f is vertex row_ids[f], so a candidate
    equal to row_ids[f] is the self loop and dropped, not one equal to f."""
    rng = np.random.default_rng(5)
    row_ids = np.sort(rng.choice(1000, 40, replace=False)).astype(np.int32)
    rows = rng.integers(-1, 42, 3000).astype(np.int32)
    ids = np.where(rng.random(3000) < 0.3, row_ids[np.clip(rows, 0, 39)],
                   rng.integers(-1, 1000, 3000)).astype(np.int32)
    dist = rng.integers(0, 50, 3000).astype(np.float32)
    flag = rng.integers(0, 2, 3000).astype(np.uint8)
    for rid in (None, row_ids):
        _, rk, ri, rf = RG.bucket_scatter_tables(
            *(jnp.asarray(a) for a in (rows, ids, dist, flag)), 40, 128,
            row_ids=None if rid is None else jnp.asarray(rid))
        _, k, i, f = G.bucket_scatter_tables(
            *(torch.from_numpy(a) for a in (rows, ids, dist, flag)), 40, 128,
            row_ids=None if rid is None else torch.from_numpy(rid))
        np.testing.assert_array_equal(convert.key_to_reference(k), np.asarray(rk))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(f.numpy(), np.asarray(rf))
        b_ids = G.bucket_scatter(*(torch.from_numpy(a) for a in (rows, ids, dist, flag)), 40,
                                 128, row_ids=None if rid is None else torch.from_numpy(rid))[0]
        self_id = (torch.arange(40) if rid is None else torch.from_numpy(rid))[:, None]
        assert not (b_ids == self_id).any()


def test_streaming_config_validation_matches_reference():
    bad = [dict(seed_k=0), dict(seed_k=40, seed_l=32), dict(seed_k=30, seed_l=64),
           dict(sweeps=0), dict(splice_k=0), dict(batch_k=-1), dict(delete_fanout=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            RU.StreamingConfig(build=RRD.RNNDescentConfig(**BUILD), **kw)
        with pytest.raises(ValueError):
            StreamingConfig(build=rd.RNNDescentConfig(**BUILD), **kw)
    assert CFG.seed_search_cfg() == S.SearchConfig(l=32, k=24, max_iters=64, topk=12)


# ------------------------------------------- the reference's properties, port
@pytest.fixture(scope="module")
def corpus():
    return clustered_vectors(VectorDatasetSpec("stream", n=700, d=24, n_queries=60,
                                               n_clusters=8), device="cpu")


@pytest.fixture(scope="module")
def base_ann(corpus):
    x, _ = corpus
    return StreamingANN.from_corpus(x[:500], CFG, generator=torch.Generator().manual_seed(1),
                                    device="cpu")


def test_insert_makes_points_searchable(corpus, base_ann):
    x, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    assert ann.capacity == 512
    with pytest.raises(ValueError, match="free rows"):
        U.insert(ann.store, x[500:700], CFG)               # 12 free < 200
    new_ids = ann.insert(x[500:700])                       # grows to 1024
    assert new_ids.shape == (200,) and ann.live == 700 and ann.capacity == 1024
    ids, _ = ann.search(x[500:700], SCFG)
    assert np.mean(ids[:, 0].numpy() == new_ids) >= 0.95
    ids_old, _ = ann.search(x[:64], SCFG)
    assert np.mean(ids_old[:, 0].numpy() == np.arange(64)) >= 0.95
    _, gt = E.ground_truth(x[:700], q, k=10)
    assert E.recall_topk(ann.search(q, SCFG)[0], gt) > 0.85


def test_delete_tombstones_never_surface(corpus, base_ann):
    x, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    _, gt = E.ground_truth(x[:500], q, k=3)
    hot = np.unique(gt.numpy().ravel())[:60]               # ids the queries hit
    assert ann.delete(hot).all()
    st = ann.store
    assert int(st.tombstone.sum()) == len(hot)
    assert (st.graph.neighbors[torch.from_numpy(hot)] >= 0).any()   # bridges stay
    ids, _ = ann.search(q, SCFG)
    assert not np.isin(ids.numpy(), hot).any()
    valid = ST.active_mask(st)
    _, gt_v = E.ground_truth(st.x, q, k=10, valid=valid)
    assert E.recall_topk(ids, gt_v, valid=valid) > 0.85


def test_delete_is_idempotent_and_bounds_checked(base_ann):
    st = base_ann.store
    st1 = U.delete(st, np.array([3, 3, 5]), CFG)
    st2 = U.delete(st1, np.array([3, 5, -7, 10**6]), CFG)   # junk ids skipped
    assert int(st2.tombstone.sum()) == 2 and st2 is st1      # no-op: same epoch
    ann = StreamingANN(store=st1, cfg=CFG)
    assert ann.delete([3, 7, 7]).tolist() == [False, True, True]
    with pytest.raises(IndexError, match="out of range"):
        ann.delete([1, 512])
    with pytest.raises(IndexError, match="unoccupied"):
        ann.delete([1, 505])
    assert ann.stats() == {"epoch": 2, "capacity": 512, "occupied": 500, "live": 497,
                           "tombstones": 3}


def test_epoch_snapshot_serves_old_graph(corpus, base_ann):
    x, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    epoch0, snap = ann.snapshot()
    ids0, d0 = ann.search(q, SCFG)
    ann.insert(x[500:560])
    ann.delete(np.arange(40))
    assert ann.epoch == epoch0 + 2
    ids1, d1 = ann.search(q, SCFG, store=snap)
    assert torch.equal(ids0, ids1) and torch.equal(d0, d1)
    valid = ST.active_mask(snap)
    ep = S.default_entry_point(snap.x, SCFG.metric, valid=valid)
    ids2, _ = S.search_tiled(snap.x, snap.graph, q, ep, SCFG, tile_b=64, valid=valid)
    assert torch.equal(ids0, ids2)
    assert not torch.equal(ids0, ann.search(q, SCFG)[0])


def test_compact_and_last_remap_survive_checkpoint(corpus, base_ann, tmp_path):
    x, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    ann.insert(x[500:600])
    ann.delete(np.arange(0, 150))
    ann.save(str(tmp_path / "pre"))
    assert ann.last_remap is None
    assert StreamingANN.restore(str(tmp_path / "pre"), CFG, device="cpu").last_remap is None
    remap = ann.compact()
    st = ann.store
    assert ann.live == 450 and st.capacity == 512 and int(st.tombstone.sum()) == 0
    assert (remap[:150] == -1).all() and np.array_equal(np.sort(remap[150:600]),
                                                        np.arange(450))
    assert torch.equal(st.x[int(remap[150])], x[150])
    nb, d = st.graph.neighbors[:450], st.graph.dists[:450]
    assert int(st.graph.neighbors.max()) < 450
    assert torch.equal(nb >= 0, torch.isfinite(d))
    assert (torch.diff(torch.where(torch.isfinite(d), d, 3e38), dim=1) >= 0).all()
    valid = ST.active_mask(st)
    _, gt = E.ground_truth(st.x, q, k=10, valid=valid)
    ids, dists = ann.search(q, SCFG)
    assert E.recall_topk(ids, gt, valid=valid) > 0.85
    ann.save(str(tmp_path / "post"))
    back = StreamingANN.restore(str(tmp_path / "post"), device="cpu")
    assert back.cfg.build.capacity == 24 and back.epoch == ann.epoch
    assert np.array_equal(back.last_remap, remap)
    for (na, a), (nb, b) in zip(flatten(back.store), flatten(st)):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b)
    ids_b, dists_b = back.search(q, SCFG)
    assert torch.equal(ids_b, ids) and torch.equal(dists_b, dists)


def test_quantized_store_search_and_insert(corpus, base_ann):
    """int8 and PQ codes on the port's store: trained on live rows, updated
    on insert in the frozen code space, searched with the rerank tail;
    deleted rows never surface."""
    from repro_torch.quant import Quantization, encode_rows
    x, q = corpus
    for quant in (Quantization(mode="int8", rerank_k=32),
                  Quantization(mode="pq", m=4, pq_iters=2, rerank_k=32)):
        ann = StreamingANN(store=base_ann.store, cfg=CFG)
        with pytest.raises(ValueError, match="no codes"):
            ann.search(q, dataclasses.replace(SCFG, quant=quant))
        ann.quantize(quant)
        new_ids = ann.insert(x[500:560])
        assert torch.equal(ann.store.qx.codes[torch.from_numpy(new_ids).long()],
                           encode_rows(x[500:560], ann.store.qx))
        ann.delete(np.arange(20))
        ids, _ = ann.search(x[500:560], dataclasses.replace(SCFG, quant=quant))
        assert np.mean(ids[:, 0].numpy() == new_ids) >= 0.95
        assert not np.isin(ids.numpy(), np.arange(20)).any()


@pytest.mark.parametrize("n_sim", [1, 2, 4])
def test_frontier_exchange_simulated_matches_single_device(int_store, n_sim, monkeypatch):
    """The sharded frontier sweep simulated in one process: the frontier
    padded to a multiple of ``n_sim`` blocks, each block's rows pruned on
    their own (``_sweep_slice``), every destination block's tables folded
    from every block's partial (``combine_bucket_tables_pair``, in the
    ring's order) and merged: the rows of both sweeps of an insert equal
    the single-device sweep's bit for bit, and the padded rows stay empty."""
    x, _, _, st_q = int_store
    pst = _port(RST.grow(st_q, 700))
    calls, orig = [], U._frontier_sweep

    def spy(xx, g, *rest):
        g = G.Graph(*(t.clone() for t in g))      # the insert writes into g's buffers
        out = orig(xx, g, *rest)
        calls.append(((xx, g, *rest), out))
        return out

    monkeypatch.setattr(U, "_frontier_sweep", spy)
    U.insert(pst, x[500:600], CFG)
    assert len(calls) == CFG.sweeps
    for (xx, g, frontier, er, ei, ed, cfg, f_pad, mesh), want in calls:
        assert mesh is None and want.n == f_pad
        fp = U._round_up(f_pad, n_sim)
        fr = torch.cat([frontier, frontier.new_full((fp - f_pad,), g.n)])
        blk = fp // n_sim
        parts = [U._sweep_slice(xx, g, fr[r * blk:(r + 1) * blk], fr, er, ei, ed, cfg, fp)
                 for r in range(n_sim)]
        rows = []
        for b in range(n_sim):
            acc = parts[b][1](b * blk, blk)
            for j in range(1, n_sim):
                acc = G.combine_bucket_tables_pair(acc, parts[(b - j) % n_sim][1](b * blk, blk))
            rows.append(U._merge_tables(parts[b][0], acc))
        got = G.Graph(*(torch.cat(t) for t in zip(*rows)))
        for a, w in zip(got, want):
            assert torch.equal(a[:f_pad], w)
        assert bool((got.neighbors[f_pad:] == -1).all())
