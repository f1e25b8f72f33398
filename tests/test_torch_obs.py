"""Port parity of the rest of ``obs``: the per-sweep graph readouts
(``obs.graphstats``), the spans of the three index builds and of the tiled
search, ``obs.cudahooks`` on the CPU, and ``python -m repro_torch.obs``,
against the reference (JAX, CPU) where it has a counterpart.

Builds start from the reference's own RandomGraph(S) (``jax.random`` and
torch generators draw different graphs) on an integer-valued corpus, so the
traced graphs are bit for bit the reference's and the span attributes and
metric values compare exactly. Both packages' tracers and registries are
reset around each test.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import graph as RG
from repro.core import nn_descent as RNN
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro.obs import graphstats as rgs
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro_torch import convert, obs
from repro_torch.core import graph as G
from repro_torch.core import nn_descent as nnd
from repro_torch.core import nsg_style as nsg
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.obs import cudahooks, graphstats, metrics, trace
from repro_torch.quant import Quantization

torch.set_num_threads(1)

N, DIM = 400, 16
RNN_KW = dict(s=8, r=16, t1=2, t2=3, capacity=32, chunk=128)
NN_KW = dict(k=12, s=6, iters=3)
SEARCH_KW = dict(l=16, k=16, max_iters=48, topk=5, visited="dense")


@pytest.fixture(autouse=True)
def clean_obs():
    for pkg in (obs, robs):
        pkg.disable()
        pkg.reset()
    yield
    for pkg in (obs, robs):
        pkg.disable()
        pkg.reset()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (N, DIM)).astype(np.float32)
    q = rng.integers(-8, 9, (24, DIM)).astype(np.float32)
    return x, q


def _port_init(monkeypatch, module, ref_init):
    g = convert.graph_from_numpy(*(np.asarray(a) for a in ref_init), device="cpu")
    monkeypatch.setattr(module, "random_init", lambda *a, **k: g)


def _same_graph(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _spans(events, prefix):
    return [(e["name"], e["attrs"]) for e in events if e["name"].startswith(prefix)]


def _assert_spans_match(ref_events, port_events, prefix):
    """Same span names in the same order; every attribute the reference
    records carries the same value on the port's span."""
    ref, port = _spans(ref_events, prefix), _spans(port_events, prefix)
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (_, ra), (_, pa) in zip(ref, port):
        for k, v in ra.items():
            assert pa[k] == v, k


def _families(snap: dict, prefixes) -> dict:
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


# --------------------------------------------------------------- graphstats
def test_graphstats_match_reference_on_one_graph():
    rng = np.random.default_rng(0)
    nb = rng.integers(-1, 50, (50, 12)).astype(np.int32)
    ds = np.where(nb >= 0, rng.random((50, 12)), np.inf).astype(np.float32)
    fl = rng.integers(0, 2, (50, 12)).astype(np.uint8)
    rg = RG.Graph(jnp.asarray(nb), jnp.asarray(ds), jnp.asarray(fl))
    pg = convert.graph_from_numpy(nb, ds, fl, device="cpu")
    assert graphstats.sweep_stats(pg) == rgs.sweep_stats(rg)
    assert graphstats.OCCUPANCY_BUCKETS == rgs.OCCUPANCY_BUCKETS

    class Collect(dict):
        def set(self, **kw):
            self.update(kw)
            return self

    got, want = Collect(), Collect()
    live = graphstats.record_sweep(got, pg, algo="rnn_descent", phase="sweep",
                                   prev_live=400, sweep=3)
    assert live == rgs.record_sweep(want, rg, algo="rnn_descent", phase="sweep",
                                    prev_live=400, sweep=3)
    graphstats.record_sweep(got, pg, algo="nsg_style", phase="reverse")
    rgs.record_sweep(want, rg, algo="nsg_style", phase="reverse")
    assert got == want
    assert metrics.REGISTRY.snapshot() == rmetrics.REGISTRY.snapshot()


# --------------------------------------------------- traced against untraced
def test_rnn_descent_traced_matches_untraced_and_the_reference(corpus, monkeypatch):
    x, q = corpus
    rcfg = RRD.RNNDescentConfig(**RNN_KW)
    key = jax.random.PRNGKey(3)
    _port_init(monkeypatch, rd, RRD.random_init(key, jnp.asarray(x), rcfg))
    cfg = rd.RNNDescentConfig(**RNN_KW)
    xt = torch.from_numpy(x)
    g0 = rd.build(xt, cfg)

    robs.enable(install_jax_hooks=False)
    ref = RRD.build(jnp.asarray(x), rcfg, key)
    scfg = RS.SearchConfig(**SEARCH_KW)
    rids, rdists, rstats = RS.search_tiled(jnp.asarray(x), ref, jnp.asarray(q), jnp.int32(0),
                                           scfg, tile_b=8, with_stats=True)
    robs.disable()

    obs.enable(install_hooks=False)
    g1 = rd.build(xt, cfg)
    ids, dists, stats = S.search_tiled(xt, g1, torch.from_numpy(q), 0,
                                       S.SearchConfig(**SEARCH_KW), tile_b=8,
                                       with_stats=True, device="cpu")
    obs.disable()
    assert _same_graph(g0, g1)
    for a, b in zip(convert.graph_to_numpy(g1), ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(dists.numpy(), np.asarray(rdists))
    assert stats["work"] == int(rstats["work"])

    rev, pev = rtrace.events(), trace.events()
    names = [n for n, _ in _spans(pev, "rnn_descent/")]
    assert names.count("rnn_descent/sweep") == RNN_KW["t1"] * RNN_KW["t2"]
    assert names.count("rnn_descent/reverse") == RNN_KW["t1"] - 1
    _assert_spans_match(rev, pev, "rnn_descent/")
    _assert_spans_match(rev, pev, "search/")
    assert all(a["launches"] == 0 for _, a in _spans(pev, "rnn_descent/"))   # CPU: plain
    fams = ("build_", "search_")
    assert _families(metrics.REGISTRY.snapshot(), fams) == \
        _families(rmetrics.REGISTRY.snapshot(), fams)


def test_nn_descent_traced_matches_untraced_and_the_reference(corpus, monkeypatch):
    x, _ = corpus
    rcfg = RNN.NNDescentConfig(**NN_KW)
    key = jax.random.PRNGKey(4)
    _port_init(monkeypatch, nnd, RNN.random_init(key, jnp.asarray(x), rcfg))
    cfg = nnd.NNDescentConfig(**NN_KW)
    xt = torch.from_numpy(x)
    g0 = nnd.build(xt, cfg)
    robs.enable(install_jax_hooks=False)
    ref = RNN.build(jnp.asarray(x), rcfg, key)
    robs.disable()
    obs.enable(install_hooks=False)
    g1 = nnd.build(xt, cfg)
    obs.disable()
    assert _same_graph(g0, g1)
    for a, b in zip(convert.graph_to_numpy(g1), ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    _assert_spans_match(rtrace.events(), trace.events(), "nn_descent/")
    assert len(_spans(trace.events(), "nn_descent/iter")) == NN_KW["iters"]
    assert _families(metrics.REGISTRY.snapshot(), ("build_",)) == \
        _families(rmetrics.REGISTRY.snapshot(), ("build_",))


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_rnn_descent_traced_equals_untraced(corpus, mode):
    x, _ = corpus
    quant = Quantization(mode="int8") if mode == "int8" else Quantization()
    cfg = rd.RNNDescentConfig(**RNN_KW, quant=quant)
    g0 = rd.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(2))
    obs.enable(install_hooks=False)
    g1 = rd.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(2))
    obs.disable()
    assert _same_graph(g0, g1)
    sweeps = _spans(trace.events(), "rnn_descent/sweep")
    assert [a["sweep"] for _, a in sweeps] == list(range(RNN_KW["t1"] * RNN_KW["t2"]))


def _inside(inner, outer, slack_s=0.0) -> bool:
    return (inner["start_s"] >= outer["start_s"] - slack_s and
            inner["start_s"] + inner["dur_s"] <= outer["start_s"] + outer["dur_s"] + slack_s)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_sweep_prune_and_merge_spans_count_their_work(corpus, monkeypatch, mode):
    """Each traced sweep holds one ``rng_prune/rows`` and one ``graph/merge``
    span at depth 1; their counts equal a recomputation from the sweep's
    input graph, its prune and the merged flags; the input rows keep their
    valid slots leading (the prune roofline's model); the card is waited
    for once a sweep (``graphstats.sync``); the graph is the untraced one
    bit for bit."""
    x, _ = corpus
    quant = Quantization(mode="int8") if mode == "int8" else Quantization()
    cfg = rd.RNNDescentConfig(**RNN_KW, quant=quant)
    g0 = rd.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(2))

    sweeps, syncs = [], []
    inner_update, inner_sync = rd.update_neighbors, graphstats.sync

    def update(xg, g, c, qx=None):
        out = inner_update(xg, g, c, qx=qx)
        _, red_w, red_d = rd.prune_rows(xg, g.neighbors, g.dists, g.flags, c, qx=qx)
        sweeps.append((g, out, red_w.numpy(), red_d.numpy()))
        return out

    monkeypatch.setattr(rd, "update_neighbors", update)
    monkeypatch.setattr(graphstats, "sync", lambda t: syncs.append(inner_sync(t)))
    obs.enable(install_hooks=False)
    g1 = rd.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(2))
    obs.disable()
    assert _same_graph(g0, g1)
    n_sweeps = RNN_KW["t1"] * RNN_KW["t2"]
    assert len(syncs) == n_sweeps + RNN_KW["t1"] - 1      # one a sweep, one a reverse pass

    evs = trace.events()
    by = {k: [e for e in evs if e["name"] == k]
          for k in ("rnn_descent/sweep", "rng_prune/rows", "graph/merge")}
    assert all(len(v) == n_sweeps for v in by.values())
    for sw, pr, mg, (g_in, g_out, red_w, red_d) in zip(*by.values(), sweeps):
        assert sw["depth"] == 0 and pr["depth"] == 1 and mg["depth"] == 1
        assert _inside(pr, sw) and _inside(mg, sw)
        assert pr["start_s"] + pr["dur_s"] <= mg["start_s"]
        valid = g_in.neighbors.numpy() >= 0
        v = valid.sum(1).astype(np.int64)
        assert (valid == (np.arange(valid.shape[1])[None, :] < v[:, None])).all()
        assert pr["attrs"] == {"launches": 0, "rows": N, "m": RNN_KW["capacity"], "d": DIM,
                               "itemsize": 1 if mode == "int8" else 4,
                               "cands_valid": int(v.sum()), "cands_valid_sq": int((v * v).sum())}
        new = (g_out.flags.numpy() == 1) & (g_out.neighbors.numpy() >= 0)
        ids = g_in.neighbors.numpy()
        real = (red_w >= 0) & (red_w < N) & (ids >= 0) & (red_w != ids) & ~np.isnan(red_d)
        assert mg["attrs"] == {"launches": 0, "rows": N, "m": RNN_KW["capacity"],
                               "rows_changed": int(new.any(1).sum()),
                               "cands_scattered": int(real.sum())}
        assert mg["attrs"]["cands_scattered"] > 0
        assert 0 < mg["attrs"]["rows_changed"] <= N
        assert sw["attrs"]["edges_new"] == int(new.sum())


def test_row_counts_are_taken_once_a_graph_state():
    """A graph state is reduced once for its per-row counts: counting it
    again (the sweep's readouts, the next prune) reads the kept counts; a
    new state, or the same tensors changed in place, are counted anew."""
    nb = torch.tensor([[3, 1, -1], [-1, -1, -1], [0, 2, 1]], dtype=torch.int32)
    fl = torch.tensor([[1, 0, 0], [1, 0, 0], [0, 0, 1]], dtype=torch.uint8)
    g = G.Graph(neighbors=nb, dists=torch.zeros(3, 3), flags=fl)
    live, new = graphstats.row_counts(g)
    assert live.tolist() == [2, 0, 3] and new.tolist() == [1, 0, 1]
    assert graphstats.row_counts(g)[0] is live
    assert graphstats.prune_counts(g) == {"cands_valid": 5, "cands_valid_sq": 13}
    assert graphstats.merge_counts(g) == {"rows_changed": 2}
    assert graphstats.sweep_stats(g) == {"edges_live": 5, "edges_new": 2, "occupancy": 5 / 9}
    fl[2, 2] = 0
    assert graphstats.row_counts(g)[1].tolist() == [1, 0, 0]
    g2 = G.Graph(neighbors=nb.clone(), dists=g.dists, flags=fl)
    assert graphstats.row_counts(g2)[0] is not graphstats.row_counts(g)[0]
    with torch.inference_mode():
        g3 = G.Graph(*(t.clone() for t in g))
    assert graphstats.row_counts(g3)[1].tolist() == [1, 0, 0]
    assert graphstats.row_counts(g3)[0] is not graphstats.row_counts(g3)[0]


def test_compact_repair_sweep_waits_once_for_its_spans(corpus, monkeypatch):
    """Traced, ``compact``'s repair sweep is one costed ``streaming/repair``
    span; the sweep's prune and merge spans sit under it at depth 1 and get
    their counts when it ends, not at their own exits."""
    from repro_torch.streaming import StreamingANN
    from repro_torch.streaming import updates as U
    x, _ = corpus
    cfg = U.StreamingConfig(build=rd.RNNDescentConfig(**RNN_KW))
    ann = StreamingANN.from_corpus(torch.from_numpy(x[:200]), cfg)
    ann.delete(np.arange(0, 200, 7))
    obs.reset()
    obs.enable(install_hooks=False)
    ann.compact()
    obs.disable()
    evs = trace.events()
    (rep,) = [e for e in evs if e["name"] == "streaming/repair"]
    kids = [e for e in evs if e["name"] in ("rng_prune/rows", "graph/merge")]
    assert [e["name"] for e in kids] == ["rng_prune/rows", "graph/merge"]
    assert rep["depth"] == 0 and all(e["depth"] == 1 and _inside(e, rep) for e in kids)
    assert kids[0]["attrs"]["cands_valid"] > 0 and kids[1]["attrs"]["rows_changed"] >= 0


def test_spans_appear_on_the_profilers_clock(corpus):
    """Under a CPU ``torch.profiler`` every span opened by ``trace.span``
    is a host event of its name, inside its span's interval (the profiler
    stamps the wall clock, the tracer ``perf_counter``: their offset is
    read once, to a few microseconds)."""
    import time

    from torch.profiler import ProfilerActivity, profile
    x, _ = corpus
    cfg = rd.RNNDescentConfig(**{**RNN_KW, "t1": 1})
    names = ("rnn_descent/sweep", "rng_prune/rows", "graph/merge")
    obs.enable(install_hooks=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pairs = []
        for _ in range(5):
            a, w, b = trace.clock(), time.time_ns(), trace.clock()
            pairs.append((b - a, (a + b) / 2, w))
        bracket, c, w = min(pairs)
        rd.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(2))
    obs.disable()
    hosts = sorted((e.start_ns(), e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events() if e.name() in names)
    spans = sorted((e for e in trace.events() if e["name"] in names),
                   key=lambda e: e["start_s"])
    assert [h[2] for h in hosts] == [e["name"] for e in spans]
    assert len(spans) == 3 * RNN_KW["t2"]
    origin_ns = (trace._origin - c) * 1e9 + w
    for (t0, dur, _), e in zip(hosts, spans):
        ev = {"start_s": (t0 - origin_ns) / 1e9, "dur_s": dur / 1e9}
        assert _inside(ev, e, slack_s=1e-4 + bracket), (e["name"], ev, e)


def test_nsg_style_traced_equals_untraced(corpus):
    x, _ = corpus
    cfg = nsg.NSGStyleConfig(r=8, c=16, knn=nnd.NNDescentConfig(**NN_KW))
    g0 = nsg.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(6))
    obs.enable(install_hooks=False)
    g1 = nsg.build(torch.from_numpy(x), cfg, torch.Generator().manual_seed(6))
    obs.disable()
    assert _same_graph(g0, g1)
    names = [n for n, _ in _spans(trace.events(), "nsg_style/")]
    assert names == ["nsg_style/knn", "nsg_style/expand", "nsg_style/prune",
                     "nsg_style/reverse", "nsg_style/repair"]
    (expand,) = [a for n, a in _spans(trace.events(), "nsg_style/expand")]
    assert expand["pool"] == cfg.c
    assert len(_spans(trace.events(), "nn_descent/iter")) == NN_KW["iters"]


def test_obs_off_leaves_the_registry_and_trace_untouched(corpus):
    x, q = corpus
    xt = torch.from_numpy(x)
    g = rd.build(xt, rd.RNNDescentConfig(**RNN_KW), torch.Generator().manual_seed(1))
    nnd.build(xt, nnd.NNDescentConfig(**NN_KW), torch.Generator().manual_seed(1))
    S.search_tiled(xt, g, torch.from_numpy(q), 0, S.SearchConfig(**SEARCH_KW), tile_b=8,
                   with_stats=True, device="cpu")
    assert trace.events() == []
    assert metrics.REGISTRY.snapshot() == {}


# ---------------------------------------------------------------- cudahooks
def test_cudahooks_count_builds_and_loads(tmp_path, monkeypatch):
    """The build counter through ``_build.build_all`` with a stand-in
    compiler (no nvcc here) that writes its ``-o`` file, and the load
    counter through a stand-in ``ctypes.CDLL``."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info    : Used 7 registers"\n: > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    cudahooks.install()
    cudahooks.install()                                  # idempotent
    assert _build.BUILD_LISTENERS.count(cudahooks._on_build) == 1
    builds0, loads0 = cudahooks.kernel_builds(), cudahooks.kernel_libs_loaded()

    _build.build_all(("fm_interact",))                   # tracing off: tally only
    assert cudahooks.kernel_builds() == builds0 + 1
    assert "kernel_builds_total" not in metrics.REGISTRY.snapshot()
    _build.build_all(("fm_interact",))                   # built: no nvcc run
    assert cudahooks.kernel_builds() == builds0 + 1

    obs.enable()
    _build.build_all(("pairwise_l2", "beam_score_pq"))
    assert cudahooks.kernel_builds() == builds0 + 3
    snap = metrics.REGISTRY.snapshot()
    assert sorted(s["labels"]["source"] for s in snap["kernel_builds_total"]["samples"]) == \
        ["beam_score_pq", "pairwise_l2"]
    assert snap["kernel_build_seconds"]["samples"][0]["count"] == 2
    evs = [e for e in trace.events() if e["name"] == "kernel/build"]
    assert len(evs) == 2 and all(e["tid"] == cudahooks.KERNEL_TRACK_TID for e in evs)
    assert _build.ptxas_path("pairwise_l2").read_text().strip() == \
        "ptxas info    : Used 7 registers"

    class FakeLib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_OPEN", {})
    _build.load("pairwise_l2", "ppiiiipp")
    _build.load("pairwise_l2_launch_shape", "iiiip", source="pairwise_l2")   # one library
    assert cudahooks.kernel_libs_loaded() == loads0 + 1
    assert metrics.REGISTRY.snapshot()["kernel_libs_loaded_total"]["samples"][0]["value"] == 1


def test_record_memory_on_the_cpu_reports_peak_rss():
    out = cudahooks.record_memory(phase="build", device="cpu")
    assert out["host"]["peak_rss"] > 2**20
    (sample,) = metrics.REGISTRY.snapshot()["obs_device_bytes"]["samples"]
    assert sample["labels"] == {"device": "host", "kind": "peak_rss", "phase": "build"}
    assert sample["value"] == out["host"]["peak_rss"]


def test_span_costs_sets_launch_deltas(monkeypatch):
    monkeypatch.setitem(LAUNCHES, "rng_prune", LAUNCHES["rng_prune"])
    monkeypatch.setitem(LAUNCHES, "beam_score", LAUNCHES["beam_score"])
    with cudahooks.span_costs(trace.NOOP):              # tracing off: nothing at all
        LAUNCHES["rng_prune"] += 1
    obs.enable(install_hooks=False)
    with trace.span("t") as sp, cudahooks.span_costs(sp, torch.device("cpu")):
        LAUNCHES["rng_prune"] += 2
        LAUNCHES["beam_score"] += 1
    (ev,) = trace.events()
    assert ev["attrs"] == {"launches_rng_prune": 2, "launches_beam_score": 1, "launches": 3}


def test_nested_span_costs_resolve_after_the_outermost():
    """A costed block inside another one gets its launches at its own exit
    and its deferred counts only when the outermost block exits (the one
    wait of a traced sweep); with nothing around it, at once."""
    obs.enable(install_hooks=False)
    cpu = torch.device("cpu")
    with trace.span("outer") as osp, cudahooks.span_costs(osp, cpu):
        with trace.span("inner") as isp, cudahooks.span_costs(isp, cpu) as ic:
            pass
        ic.defer(a=torch.tensor(3), b=torch.tensor(4))
        assert isp.attrs == {"launches": 0}
    assert isp.attrs == {"launches": 0, "a": 3, "b": 4}
    assert type(isp.attrs["a"]) is int
    with trace.span("alone") as asp, cudahooks.span_costs(asp, cpu) as ac:
        pass
    ac.defer(c=torch.tensor(5))
    assert asp.attrs == {"launches": 0, "c": 5}


# ---------------------------------------------------------------------- CLI
def test_obs_cli_on_the_cpu(tmp_path):
    from repro_torch.obs.__main__ import main
    assert main(["--device", "cpu", "--out", str(tmp_path), "--n", "200",
                 "--requests", "48"]) == 0
    assert sorted(os.listdir(tmp_path)) == ["metrics.json", "metrics.prom", "trace.json"]
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"rnn_descent/sweep", "search/tiled", "obs/serve_session"} <= names
    assert "build_sweeps_total" in json.loads((tmp_path / "metrics.json").read_text())
