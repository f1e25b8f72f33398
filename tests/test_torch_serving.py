"""Port parity: the serving front end (``repro_torch.serving``) and its copies
of the reference's ``obs.trace`` / ``obs.metrics``.

The reference's serving tests (tests/test_serving.py) and its two telemetry
tests (tests/test_obs.py) run here on the port; the reference's
zero-recompile contract becomes "no kernel build and no torch.compile in a
session". Then the port is held against the JAX package: the arrival
schedules and the admission queue's dispatch sequence, the telemetry
summary and the metrics exposition of the same stamp script, and a whole
session under a manual clock with inserts and deletes over an integer
store the JAX package built (dense visited, both seeding searches dense),
bit for bit in every request's result and in the final store.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.obs import metrics as RM
from repro.serving import admission as RA
from repro.serving import frontend as RF
from repro.serving import loadgen as RL
from repro.serving import telemetry as RT
from repro.serving import writer as RW
from repro.streaming import store as RST
from repro.streaming import updates as RU
from repro_torch import convert, obs
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
from repro_torch.obs import metrics
from repro_torch.obs import trace as T
from repro_torch.serving import (AdmissionConfig, AdmissionQueue, BatchedWriter,
                                 DoubleBuffer, LoadSpec, ServingConfig,
                                 ServingFrontend, Telemetry, WriterConfig,
                                 arrival_times, run_session)
from repro_torch.streaming import StreamingANN, StreamingConfig
from repro_torch.streaming import store as ST
from repro_torch.streaming import updates as U

torch.set_num_threads(1)

BUILD = dict(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128)
KNOBS = dict(seed_l=32, seed_k=12, seed_iters=64, batch_k=4, sweeps=2, splice_k=6)
CFG = StreamingConfig(build=rd.RNNDescentConfig(**BUILD), **KNOBS)
RCFG = RU.StreamingConfig(build=RRD.RNNDescentConfig(**BUILD), **KNOBS)
SCFG = S.SearchConfig(l=32, k=16, max_iters=96, topk=10)


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with the port's obs disabled and clean."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture(scope="module")
def corpus():
    x, q = clustered_vectors(VectorDatasetSpec("serve", n=700, d=24, n_queries=60,
                                               n_clusters=8), device="cpu")
    return x.numpy(), q.numpy()


@pytest.fixture(scope="module")
def base_ann(corpus):
    x, _ = corpus
    return StreamingANN.from_corpus(x[:500], CFG, generator=torch.Generator().manual_seed(1),
                                    device="cpu")


class ManualClock:
    """Deterministic monotonic clock for replaying sessions."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


# ------------------------------------------------------------ admission unit
def test_admission_size_trigger():
    q = AdmissionQueue(AdmissionConfig(tile_lanes=4, deadline_s=1.0,
                                       dispatch_fraction=0.5))
    row = np.zeros((8,), np.float32)
    for _ in range(3):
        q.submit(row, now=0.0)
    assert q.depth() == 3
    assert not q.ready(now=0.2)          # partial, budget barely touched
    q.submit(row, now=0.2)
    assert q.ready(now=0.2)              # full tile dispatches immediately
    reqs = q.take()
    assert [r.rid for r in reqs] == [0, 1, 2, 3]   # FIFO, dense rids
    assert q.depth() == 0 and not q.ready(now=0.2)


def test_admission_deadline_trigger():
    q = AdmissionQueue(AdmissionConfig(tile_lanes=64, deadline_s=0.1,
                                       dispatch_fraction=0.5))
    q.submit(np.zeros((4,), np.float32), now=1.0)
    assert not q.ready(now=1.049)        # oldest has spent < half its budget
    assert q.next_trigger() == pytest.approx(1.05)
    assert q.ready(now=1.05)             # ... and dispatches at half
    q.take()
    q.submit(np.zeros((4,), np.float32), now=2.0, deadline_s=1.0)
    assert not q.ready(now=2.4)
    assert q.ready(now=2.5)
    with pytest.raises(ValueError):
        AdmissionConfig(tile_lanes=8, max_queue=4)


def test_admission_overflow_sheds():
    q = AdmissionQueue(AdmissionConfig(tile_lanes=2, max_queue=2))
    q.submit(np.zeros(2, np.float32), now=0.0)
    q.submit(np.zeros(2, np.float32), now=0.0)
    with pytest.raises(OverflowError):
        q.submit(np.zeros(2, np.float32), now=0.0)


def test_staging_fixed_shape_and_zeroed_lanes():
    db = DoubleBuffer(tile_lanes=4, d=3, device="cpu")
    rows = [np.full((3,), 7.0, np.float32), np.full((3,), 9.0, np.float32)]
    t = db.stage(rows)
    assert t.shape == (4, 3) and t.dtype == torch.float32 and t.device.type == "cpu"
    assert (t[0] == 7.0).all() and (t[1] == 9.0).all()
    assert (t[2:] == 0.0).all()          # vacant lanes never alias old tiles
    mask = db.lane_mask(2)
    assert mask.dtype == torch.bool and mask.tolist() == [True, True, False, False]
    with pytest.raises(ValueError):
        db.stage([rows[0]] * 5)
    with pytest.raises(ValueError):
        DoubleBuffer(tile_lanes=4, d=3, depth=1, device="cpu")


def test_staging_ring_keeps_each_tile_its_rows():
    """Three stage() calls on a ring of two buffers without a harvest: the
    third rewrites the first buffer, and every returned block still holds
    its own rows (a CPU block is a copy, never a view of the buffer)."""
    db = DoubleBuffer(tile_lanes=4, d=5, depth=2, device="cpu")
    tiles = [[np.full((5,), 10.0 * t + i, np.float32) for i in range(4 - t)]
             for t in range(3)]
    out = [db.stage(rows) for rows in tiles]
    for t, (rows, blk) in enumerate(zip(tiles, out)):
        assert torch.equal(blk[:len(rows)], torch.from_numpy(np.stack(rows))), t
        assert (blk[len(rows):] == 0).all(), t
    assert out[0].data_ptr() != out[2].data_ptr()


# ------------------------------------------------- delete surfacing (index)
def test_delete_returns_tombstoned_now_mask(base_ann):
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    mask = ann.delete(np.array([3, 5, 9]))
    assert mask.dtype == bool and mask.tolist() == [True, True, True]
    ep = ann.epoch
    again = ann.delete(np.array([5, 11]))
    assert again.tolist() == [False, True]
    assert ann.epoch == ep + 1
    noop = ann.delete(np.array([3, 5, 9, 11]))
    assert noop.tolist() == [False] * 4
    assert ann.epoch == ep + 1           # all-dead batch is a no-op


def test_delete_raises_on_bad_ids(base_ann):
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    with pytest.raises(IndexError):
        ann.delete(np.array([-1]))
    with pytest.raises(IndexError):
        ann.delete(np.array([ann.capacity]))
    with pytest.raises(IndexError):
        ann.delete(np.array([ann.capacity - 1]))     # padded, never occupied
    assert int(ann.store.tombstone.sum()) == 0


# ------------------------------------------------------------------- writer
def test_writer_fixed_batches_and_tickets(corpus, base_ann):
    x, _ = corpus
    ann = StreamingANN(store=ST.grow(base_ann.store, 600), cfg=CFG)
    w = BatchedWriter(ann, WriterConfig(insert_batch=4, delete_batch=4))
    t1 = w.submit_insert(x[500:503])     # 3 rows: below one batch
    assert w.commit() == 0 and not t1.done
    t2 = w.submit_insert(x[503:505])     # 2 more: one full batch + 1 tail
    assert w.commit() == 1
    assert t1.done and not t2.done
    assert np.all(t1.ids >= 0)
    live0 = int(ann.live)
    t3 = w.submit_delete(t1.ids)
    td = w.submit_delete(np.array([int(t1.ids[0])]))
    assert w.commit() == 1 and t3.done and td.done
    assert t3.mask().tolist() == [True, True, True]
    assert td.mask().tolist() == [True]
    assert int(ann.live) == live0 - 3
    t5 = w.submit_delete(np.concatenate([t1.ids, t1.ids[:1]]))
    ep = ann.epoch
    assert w.commit() == 1 and t5.mask().tolist() == [False] * 4
    assert ann.epoch == ep
    assert w.commit(force=True) == 1 and t2.done
    assert w.pending() == (0, 0)
    with pytest.raises(ValueError):
        t2.mask()


# ------------------------------------------------- determinism across tiles
def _frontend(ann, tile_lanes, clock, search=SCFG, wb=4, **kw):
    return ServingFrontend(
        ann,
        ServingConfig(admission=AdmissionConfig(tile_lanes=tile_lanes, deadline_s=0.05),
                      writer=WriterConfig(insert_batch=wb, delete_batch=wb),
                      search=search, **kw),
        clock=clock)


def _serve_all(ann, queries, tile_lanes, clock_dt, pump_every=1, search=SCFG):
    """Submit every query in order, pumping every ``pump_every`` submits
    with a manual clock advancing ``clock_dt`` per submit; returns
    {rid: (ids, dists)} after drain."""
    clock = ManualClock()
    fe = _frontend(ann, tile_lanes, clock, search=search)
    rids = []
    for i, row in enumerate(queries):
        rids.append(fe.submit(row))
        clock.advance(clock_dt)
        if (i + 1) % pump_every == 0:
            fe.pump()
    fe.drain()
    return {r: fe.result(r) for r in rids}


@pytest.mark.parametrize("visited", ["hashed", "dense"])
def test_results_independent_of_coalescing(corpus, base_ann, visited):
    """Per-request results are a function of (query, store epoch) only —
    never of tile width, lane position, occupancy, or pump cadence."""
    _, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    scfg = dataclasses.replace(SCFG, visited=visited)
    ref = _serve_all(ann, q, tile_lanes=16, clock_dt=0.0, search=scfg)
    for lanes, dt, every in ((4, 0.0, 1), (16, 0.03, 1), (7, 0.001, 1),
                             (16, 0.0, 5)):
        got = _serve_all(ann, q, tile_lanes=lanes, clock_dt=dt, pump_every=every,
                         search=scfg)
        assert got.keys() == ref.keys()
        for rid in ref:
            assert np.array_equal(got[rid][0], ref[rid][0]), (lanes, dt, every, rid)
            assert np.array_equal(got[rid][1], ref[rid][1]), (lanes, dt, every, rid)
            assert got[rid][0].dtype == np.int32 and got[rid][1].dtype == np.float32


def test_epoch_snapshot_pins_inflight_tile(corpus, base_ann):
    """A dispatched tile serves the store it was dispatched against, even
    when the writer commits new epochs before the tile is harvested."""
    _, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    lanes = 8
    fe = ServingFrontend(
        ann,
        ServingConfig(admission=AdmissionConfig(tile_lanes=lanes),
                      writer=WriterConfig(insert_batch=8, delete_batch=8),
                      search=SCFG, pipeline_depth=2),
        clock=ManualClock())
    epoch0, st0 = ann.snapshot()
    rids = [fe.submit(row) for row in q[:lanes]]
    fe.pump()                            # dispatches; depth 2 keeps it in flight
    assert len(fe._inflight) == 1
    fe.submit_delete(np.arange(0, 8))
    fe.writer.commit()
    assert ann.epoch == epoch0 + 1       # the index moved on...
    fe.drain(flush_writes=False)
    # ... but the tile's results equal a direct search of the old store
    eps = S.default_entry_point(st0.x, SCFG.metric, valid=ST.active_mask(st0))
    want_ids, want_d = ann.search(torch.from_numpy(q[:lanes]), SCFG, entry_points=eps,
                                  tile_b=lanes, lane_valid=torch.ones((lanes,), dtype=torch.bool),
                                  store=st0)
    for lane, rid in enumerate(rids):
        ids, dists = fe.result(rid)
        assert np.array_equal(ids, want_ids[lane].numpy())
        assert np.array_equal(dists, want_d[lane].numpy())
    assert fe.telemetry.summary()["staleness_max"] >= 1


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_fixed_order_scores_match_score_block(metric):
    """score_lanes (the search's seeds and rerank) is score_block with its
    sums in one fixed order: equal on integer-valued inputs, within f32
    rounding on real ones; lane_sum sums any width."""
    from repro_torch.kernels.beam_score.ref import lane_sum, score_block, score_lanes
    rng = np.random.default_rng(6)
    ints = (torch.from_numpy(rng.integers(-8, 9, (9, 5, 37)).astype(np.float32)),
            torch.from_numpy(rng.integers(-8, 9, (9, 37)).astype(np.float32)))
    reals = (torch.from_numpy(rng.standard_normal((9, 5, 37)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((9, 37)).astype(np.float32)))
    if metric != "cos":
        assert torch.equal(score_lanes(*ints, metric), score_block(*ints, metric))
    torch.testing.assert_close(score_lanes(*reals, metric), score_block(*reals, metric),
                               rtol=1e-5, atol=1e-5)
    for w in (1, 2, 3, 37, 128):
        t = torch.arange(4 * w, dtype=torch.float32).reshape(4, w)
        assert torch.equal(lane_sum(t), t.sum(-1))


def test_corpus_shard_and_missing_codes_raise(base_ann):
    from repro_torch.quant import Quantization
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    ServingConfig(shard="corpus")                    # validates as in the reference
    with pytest.raises(ValueError, match="mesh"):
        ServingFrontend(ann, ServingConfig(shard="corpus"))
    with pytest.raises(ValueError, match="codes"):
        ServingFrontend(ann, ServingConfig(search=dataclasses.replace(
            SCFG, quant=Quantization(mode="int8", rerank_k=32))))
    with pytest.raises(ValueError):
        ServingConfig(shard="rows")
    with pytest.raises(ValueError):
        ServingConfig(pipeline_depth=0)


# ------------------------------------------------ no builds in steady state
def _warm(ann, pool, q, lanes, wb):
    """Touch every steady-state shape once: a full tile, one insert batch,
    one delete batch, the entry-point refresh."""
    _, st = ann.snapshot()
    eps = S.default_entry_point(st.x, SCFG.metric, valid=ST.active_mask(st))
    ann.search(torch.from_numpy(q[:lanes]), SCFG, entry_points=eps, tile_b=lanes,
               lane_valid=torch.ones((lanes,), dtype=torch.bool), store=st)
    ann.insert(pool[:wb])
    ann.delete(np.arange(24, 24 + wb))


def _session_writes(pool, wb, events=3):
    writes = []
    for e in range(events):
        writes += [(10 * (e + 1), "insert", pool[wb * (e + 1):wb * (e + 2)]),
                   (10 * (e + 1), "delete", np.arange(32 + wb * e, 32 + wb * (e + 1)))]
    return writes


def test_scripted_session_builds_and_compiles_nothing(corpus, base_ann, monkeypatch):
    """After the warm-up, a whole scripted session (searches, deadline-
    triggered partial tiles, fixed-size commits, drain) builds no kernel
    and calls torch.compile nowhere."""
    from repro_torch.kernels import _build
    x, q = corpus
    lanes, wb = 8, 4
    ann = StreamingANN(store=ST.grow(base_ann.store, 560), cfg=CFG)
    pool = x[500:]
    _warm(ann, pool, q, lanes, wb)
    calls = []
    for mod, name in ((_build, "build_all"), (_build, "load"), (torch, "compile")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _o=orig, **k: (calls.append(_n),
                                                                          _o(*a, **k))[1])
    libs = len(_build._LIBS)
    fe = _frontend(ann, lanes, time.perf_counter)
    summ = run_session(fe, q, LoadSpec(n_requests=40, qps=2000.0, deadline_s=0.05, seed=3),
                       writes=_session_writes(pool, wb))
    assert summ["completed"] == 40
    assert summ["rows_written"] == {"insert": 12, "delete": 12}
    assert calls == [] and len(_build._LIBS) == libs
    assert ann.capacity == 1024                  # no growth landed mid-session


# ---------------------------------------------------------------- telemetry
def test_session_telemetry_summary(corpus, base_ann):
    _, q = corpus
    ann = StreamingANN(store=base_ann.store, cfg=CFG)
    fe = ServingFrontend(ann, ServingConfig(admission=AdmissionConfig(tile_lanes=8),
                                            search=SCFG))
    summ = run_session(fe, q, LoadSpec(n_requests=30, qps=5000.0, deadline_s=0.25, seed=1))
    assert summ["completed"] == 30 and len(summ["rids"]) == 30
    lat = summ["latency_ms"]
    assert 0 <= lat["p50"] <= lat["p95"] <= lat["p99"]
    assert summ["dispatch_wait_ms"]["p50"] >= 0
    assert 0 < summ["occupancy_mean"] <= 1.0
    assert sum(summ["occupancy_hist"]["counts"]) == summ["tiles"]
    assert summ["achieved_qps"] > 0
    assert summ["staleness_max"] == 0    # no writes in this session


def test_loadgen_deterministic_schedules():
    a = arrival_times(LoadSpec(n_requests=64, qps=100.0, seed=7))
    b = arrival_times(LoadSpec(n_requests=64, qps=100.0, seed=7))
    c = arrival_times(LoadSpec(n_requests=64, qps=100.0, seed=8))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0)
    u = arrival_times(LoadSpec(n_requests=5, qps=10.0, arrival="uniform"))
    assert np.allclose(u, np.arange(5) / 10.0)
    with pytest.raises(ValueError):
        LoadSpec(arrival="bursty")
    with pytest.raises(ValueError):
        LoadSpec(qps=0.0)


def test_empty_session_reports_none():
    summ = Telemetry().summary()
    assert summ["completed"] == 0
    assert summ["achieved_qps"] is None
    assert summ["deadline_hit_rate"] is None
    assert all(v is None for v in summ["latency_ms"].values())
    assert all(v is None for v in summ["dispatch_wait_ms"].values())
    assert summ["occupancy_mean"] is None
    assert summ["staleness_mean"] is None


def test_explicit_registry_mirrors_even_disabled():
    reg = metrics.Registry()
    tel = Telemetry(registry=reg)
    assert not obs.enabled()
    tel.record_enqueue(0, 0.0, 1.0)
    tel.record_dispatch([0], 0.01, occupancy=1, tile_lanes=4, queue_depth=0, epoch=0)
    tel.record_complete([0], 0.02, tile_index=0, epoch=0)
    snap = reg.snapshot()
    assert snap["serving_requests_total"]["samples"][0]["value"] == 1
    assert "serving_request_latency_seconds" in snap
    assert len(metrics.REGISTRY) == 0            # the process registry untouched


def test_obs_off_is_a_no_op_and_on_changes_no_result(corpus, base_ann):
    """With obs off a session records no span and leaves the process
    registry empty; with obs on it records the serving spans and metrics,
    and every result is the same bit for bit."""
    x, q = corpus

    def session():
        ann = StreamingANN(store=ST.grow(base_ann.store, 560), cfg=CFG)
        clock = ManualClock()
        fe = _frontend(ann, 8, clock)
        writes = _session_writes(x[500:], 4, events=1)
        rids = []
        for i, row in enumerate(q[:24]):
            rids.append(fe.submit(row))
            for after, kind, arg in writes:
                if after == i:
                    (fe.submit_insert if kind == "insert" else fe.submit_delete)(arg)
            clock.advance(0.004)
            fe.pump()
        fe.drain()
        fe.telemetry.summary()
        return [fe.result(r) for r in rids]

    off = session()
    assert T.events() == [] and len(metrics.REGISTRY) == 0
    assert T.span("x") is T.NOOP and not T.NOOP
    with T.enabled_scope():
        on = session()
        names = {e["name"] for e in T.events()}
    assert {"serving/dispatch", "serving/stage", "serving/search_dispatch",
            "serving/readout", "serving/commit", "serving/request",
            "request/queue_wait", "request/service"} <= names
    snap = metrics.REGISTRY.snapshot()
    assert snap["serving_requests_total"]["samples"][0]["value"] == 24
    assert {s["labels"]["kind"] for s in snap["serving_rows_written_total"]["samples"]} \
        == {"insert", "delete"}
    for (a_ids, a_d), (b_ids, b_d) in zip(off, on):
        assert np.array_equal(a_ids, b_ids) and np.array_equal(a_d, b_d)


# ----------------------------------------------- held against the JAX package
@pytest.mark.parametrize("spec", [dict(n_requests=200, qps=500.0, seed=0),
                                  dict(n_requests=64, qps=37.5, seed=11),
                                  dict(n_requests=9, qps=3.0, arrival="uniform")])
def test_arrivals_and_dispatch_sequence_match_reference(spec):
    """The same spec draws the reference's arrival array bit for bit, and
    the same (submit, ready, take) stamps give the same dispatch sequence."""
    a = arrival_times(LoadSpec(**spec))
    r = RL.arrival_times(RL.LoadSpec(**spec))
    assert a.dtype == r.dtype and np.array_equal(a, r)
    rng = np.random.default_rng(4)
    budgets = rng.choice([None, 0.01, 0.2], size=a.shape[0])
    seqs = []
    for mod, cfg in ((None, AdmissionConfig), (RA, RA.AdmissionConfig)):
        qcls = AdmissionQueue if mod is None else RA.AdmissionQueue
        queue = qcls(cfg(tile_lanes=5, deadline_s=0.05, dispatch_fraction=0.5))
        seq = []
        for i, t in enumerate(a):
            queue.submit(np.full((3,), i, np.float32), now=float(t), deadline_s=budgets[i])
            seq.append(("trigger", queue.next_trigger()))
            while queue.ready(float(t)):
                seq.append(("tile", float(t), [(r.rid, r.enqueue_t, r.deadline_t)
                                               for r in queue.take()]))
        seq.append(("tail", [r.rid for r in queue.take()]))
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def _stamp_script(tel):
    """A fixed script of enqueue / dispatch / complete / commit stamps."""
    rng = np.random.default_rng(9)
    t, rid, tile, epoch = 0.0, 0, 0, 0
    for step in range(12):
        k = int(rng.integers(1, 9))
        rids = list(range(rid, rid + k))
        for r in rids:
            t += float(rng.exponential(0.003))
            tel.record_enqueue(r, t, t + 0.05)
        rid += k
        t += float(rng.exponential(0.01))
        tel.record_dispatch(rids, t, occupancy=k, tile_lanes=8,
                            queue_depth=int(rng.integers(0, 40)), epoch=epoch)
        if step % 3 == 1:
            epoch += 1
            tel.record_commit("insert" if step % 2 else "delete", 4, epoch)
        t += float(rng.exponential(0.03))
        if step != 11:                   # the last tile never completes
            tel.record_complete(rids, t, tile_index=tile, epoch=epoch,
                                work=int(rng.integers(0, 100)))
        tile += 1


def test_telemetry_summary_and_exposition_match_reference():
    port, ref = Telemetry(registry=metrics.Registry()), RT.Telemetry(registry=RM.Registry())
    _stamp_script(port)
    _stamp_script(ref)
    a, b = port.summary(), ref.summary()
    assert list(a) == list(b)
    for key in a:
        assert a[key] == b[key], key
    assert port._registry.exposition() == ref._registry.exposition()
    assert port._registry.snapshot() == ref._registry.snapshot()


def test_metrics_registry_matches_reference():
    regs = (metrics.Registry(), RM.Registry())
    for reg in regs:
        reg.counter("req_total", help="a \"quoted\"\nhelp").inc(3)
        reg.counter("req_total", kind="insert").inc(2.5)
        reg.gauge("depth", q="p50").set(7)
        reg.gauge("depth", q="p50").dec(0.25)
        h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.01, 0.5, 3.0):
            h.observe(v)
        with pytest.raises(ValueError):
            reg.gauge("req_total")
    assert regs[0].exposition() == regs[1].exposition()
    assert regs[0].snapshot() == regs[1].snapshot()


# --- a whole session under a manual clock, bit for bit against the JAX package
@pytest.fixture(scope="module")
def int_store():
    """An integer corpus (700 x 24), integer queries, and the JAX package's
    store over the first 500 rows, grown to capacity 1024."""
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (700, 24)).astype(np.float32)
    q = rng.integers(-8, 9, (60, 24)).astype(np.float32)
    g = RRD.build(jnp.asarray(x[:500]), RCFG.build, jax.random.PRNGKey(1))
    return x, q, RST.grow(RST.from_built(jnp.asarray(x[:500]), g), 600)


def _replay(fe_cls, ann, cfg, q, pool, clock):
    """Submit q in order (clock + 4 ms a request, a pump after each), with
    an insert and a delete batch after requests 10, 25 and 40."""
    fe = fe_cls(ann, cfg, clock=clock)
    writes = {10: 0, 25: 1, 40: 2}
    rids = []
    for i, row in enumerate(q):
        rids.append(fe.submit(row))
        if i in writes:
            e = writes[i]
            fe.submit_insert(pool[4 * e:4 * e + 4])
            fe.submit_delete(np.arange(30 + 6 * e, 36 + 6 * e))   # 6: a tail stays
        clock.advance(0.004)
        fe.pump()
    fe.drain()
    return fe, [fe.result(r) for r in rids]


def test_session_matches_reference_bit_for_bit(int_store, monkeypatch):
    x, q, rst = int_store
    for mod in (RU, U):
        orig = mod.StreamingConfig.seed_search_cfg
        monkeypatch.setattr(mod.StreamingConfig, "seed_search_cfg",
                            lambda self, _o=orig: dataclasses.replace(_o(self), visited="dense"))
    from repro.streaming import StreamingANN as RStreamingANN
    pool = x[500:]
    dense = dataclasses.replace(SCFG, visited="dense")
    rdense = RS.SearchConfig(l=32, k=16, max_iters=96, topk=10, visited="dense")
    adm = dict(tile_lanes=8, deadline_s=0.05)
    cfg = ServingConfig(admission=AdmissionConfig(**adm), search=dense,
                        writer=WriterConfig(insert_batch=4, delete_batch=4))
    rcfg = RF.ServingConfig(admission=RA.AdmissionConfig(**adm), search=rdense,
                            writer=RW.WriterConfig(insert_batch=4, delete_batch=4))
    ann = StreamingANN(store=convert.store_from_numpy(rst, device="cpu"), cfg=CFG)
    rann = RStreamingANN(store=rst, cfg=RCFG)
    fe, got = _replay(ServingFrontend, ann, cfg, q, pool, ManualClock())
    rfe, want = _replay(RF.ServingFrontend, rann, rcfg, q, pool, ManualClock())
    assert len(got) == len(want) == q.shape[0]
    for i, ((ids, d), (rids, rd_)) in enumerate(zip(got, want)):
        assert ids.dtype == rids.dtype and d.dtype == rd_.dtype, i
        assert np.array_equal(ids, rids), i
        assert np.array_equal(d.view(np.uint32), rd_.view(np.uint32)), i
    st, rst_f = ann.store, rann.store
    assert int(st.epoch) == int(rst_f.epoch) == 8   # 3 insert, 4 delete, 1 forced commits
    for (name, leaf), ref_leaf in zip(flatten(st), jax.tree_util.tree_leaves(rst_f)):
        ref_leaf = np.asarray(ref_leaf)
        if name.endswith("dists"):
            np.testing.assert_array_equal(convert.key_to_reference(G.dist_key(leaf)),
                                          np.asarray(RG.dist_key(jnp.asarray(ref_leaf))), err_msg=name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), ref_leaf, err_msg=name)
    a, b = fe.telemetry.summary(), rfe.telemetry.summary()
    for key in ("completed", "tiles", "occupancy_hist", "queue_depth_hist", "staleness_max",
                "staleness_mean", "write_commits", "rows_written", "latency_ms",
                "dispatch_wait_ms", "deadline_hit_rate"):
        assert a[key] == b[key], key
    assert a["tiles"] > q.shape[0] // 8
    assert a["rows_written"] == {"insert": 12, "delete": 18}
