"""Port parity: the paper's own architecture ``rnnd-ann`` (its configs, the
three ``ANN_SHAPES`` cells, the ``ann`` family of ``launch.steps.bind``) and
the bounded pair gather of RandomGraph(S), against the reference (JAX, CPU).

The bound steps run at ``reduced=True`` (n = 4096, d = 32, 128 queries,
``SMOKE`` and ``SEARCH_SMOKE``) on an integer-valued corpus and integer
queries, so every distance is exact in f32 and the results are compared bit
for bit. ``ann_build`` starts from the reference's own RandomGraph(S) (the
harness of ``tests/test_torch_rng_prune.py::test_whole_build_matches_reference``:
``jax.random`` and torch generators draw different graphs). ``ann_search``
runs on the reference's built graph: with dense visited against the
reference's bound step, with the default hashed visited against the port's
own dense oracle (which of two ids racing for one hash slot wins is not
fixed across backends).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rcb
from repro.configs import rnnd_ann as r_rnnd_ann
from repro.core import distances as RD
from repro.core import rnn_descent as RRD
from repro.launch import steps as rsteps
from repro_torch import configs, convert
from repro_torch.configs import base as cb
from repro_torch.configs import rnnd_ann
from repro_torch.core import distances as D
from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.launch import steps

torch.set_num_threads(1)

SHAPES = ("build_1m", "build_gist", "search_1m")
PORT_ONLY = ("build_gist_sq8",)    # the port's own shapes (tests/test_torch_sq8_bind.py)
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.int32: torch.int32}
# the reference's kernel switches, which the port replaces by the tensor's
# device (ROADMAP, deliberate differences)
DEVICE_FIELDS = {"use_pallas", "kernel_tile_b"}


def _int_corpus(seed, n, d):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_dataclass(ref, port):
    """Every field of the reference's config equal on the port's; nested
    configs (``quant``) field by field."""
    want, got = _fields(ref), _fields(port)
    want = {k: v for k, v in want.items() if k not in DEVICE_FIELDS}
    assert set(want) == set(got), set(want) ^ set(got)
    for name, value in want.items():
        if dataclasses.is_dataclass(value):
            _same_dataclass(value, got[name])
        else:
            assert got[name] == value, name


@pytest.mark.parametrize("name", ["FULL", "SEARCH", "SMOKE", "SEARCH_SMOKE"])
def test_configs_match_reference(name):
    _same_dataclass(getattr(r_rnnd_ann, name), getattr(rnnd_ann, name))


def _shared(shapes):
    return [s for s in shapes if s.name not in PORT_ONLY]


def test_shapes_and_arch_match_reference():
    """The reference's shapes, in its order, then the port's own."""
    assert [(s.name, s.kind, s.dims) for s in _shared(cb.ANN_SHAPES)] == \
        [(s.name, s.kind, s.dims) for s in rcb.ANN_SHAPES]
    assert [s.name for s in cb.ANN_SHAPES] == list(SHAPES + PORT_ONLY)
    ref, port = rconfigs.get("rnnd-ann"), configs.get("rnnd-ann")
    assert port is rnnd_ann.ARCH
    assert (port.arch_id, port.family) == (ref.arch_id, ref.family) == ("rnnd-ann", "ann")
    assert [s.name for s in port.shapes] == list(SHAPES + PORT_ONLY)
    for shape in SHAPES:
        for reduced in (False, True):
            _same_dataclass(ref.make_config(shape, reduced), port.make_config(shape, reduced))


def test_registry_keeps_recsys_and_refuses_what_is_not_ported():
    for aid in ("wide-deep", "deepfm", "fm", "xdeepfm"):
        arch, ref = configs.get(aid), rconfigs.get(aid)
        assert arch.family == ref.family == "recsys"
        assert [(s.name, s.kind, s.dims) for s in arch.shapes] == \
            [(s.name, s.kind, s.dims) for s in ref.shapes]
    assert configs.ASSIGNED == rconfigs.ASSIGNED
    assert configs.all_cells(False) == rconfigs.all_cells(False)
    assert [c for c in configs.all_cells(True) if c[1] not in PORT_ONLY] == \
        rconfigs.all_cells(True)
    assert ("rnnd-ann", "build_gist") in configs.all_cells(include_ann=True)
    assert ("rnnd-ann", "build_gist_sq8") in configs.all_cells(include_ann=True)
    assert configs.get("dimenet").family == rconfigs.get("dimenet").family == "gnn"
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bind_matches_reference(shape, reduced):
    ref = rsteps.bind(rconfigs.get("rnnd-ann"), shape, reduced=reduced)
    port = steps.bind("rnnd-ann", shape, reduced=reduced, device="cpu")
    assert port.kind == ref.kind == rcb.ANN_SHAPES[SHAPES.index(shape)].kind
    assert port.shape.name == shape and port.device == torch.device("cpu")
    _same_dataclass(ref.cfg, port.cfg)
    assert port.init_fn(torch.Generator()) == ref.init_fn(jax.random.PRNGKey(0)) == {}
    want = {k: (tuple(v.shape), TORCH_DTYPES[v.dtype.type]) for k, v in ref.input_specs.items()}
    assert {k: (tuple(s), dt) for k, (s, dt) in port.input_specs.items()} == want
    if shape == "search_1m":
        # the query count rounds up to a multiple of 512 (10,000 -> 10,240)
        assert port.input_specs["queries"][0][0] == (128 if reduced else 10_240)


@pytest.mark.parametrize("shape", ["build_1m", "build_gist"])
def test_bound_build_matches_reference(shape, monkeypatch):
    """The bound ``ann_build`` step (``rd.build_jit``, SMOKE at 4096 x 32)
    from the reference's RandomGraph(S) gives the reference's bound step's
    graph bit for bit."""
    ref = rsteps.bind(rconfigs.get("rnnd-ann"), shape, reduced=True)
    port = steps.bind("rnnd-ann", shape, reduced=True, device="cpu")
    (n, d), _ = port.input_specs["x"]
    x = _int_corpus(3, n, d)
    want = ref.step_fn({}, {"x": jnp.asarray(x)})
    init = convert.graph_from_numpy(*(np.asarray(a) for a in RRD.random_init(
        jax.random.PRNGKey(0), jnp.asarray(x), ref.cfg)), device="cpu")
    seen = []

    def reference_init(xx, cfg, generator=None):
        seen.append(cfg)
        return init

    monkeypatch.setattr(rd, "random_init", reference_init)
    got = port.step_fn({}, {"x": torch.from_numpy(x)})
    assert seen == [rnnd_ann.SMOKE]
    for a, b in zip(convert.graph_to_numpy(got), want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def search_inputs():
    """The reduced search cell's inputs: an integer corpus, integer queries
    and the reference's SMOKE graph over the corpus."""
    x = _int_corpus(4, 4096, 32)
    q = _int_corpus(5, 128, 32)
    g = RRD.build(jnp.asarray(x), r_rnnd_ann.SMOKE, jax.random.PRNGKey(2))
    return x, q, tuple(np.array(a) for a in g)


def _search_batch(x, q, g, torch_side: bool):
    if torch_side:
        return {"x": torch.from_numpy(x), "neighbors": torch.from_numpy(g[0]),
                "dists": torch.from_numpy(g[1]), "queries": torch.from_numpy(q)}
    return {"x": jnp.asarray(x), "neighbors": jnp.asarray(g[0]), "dists": jnp.asarray(g[1]),
            "queries": jnp.asarray(q)}


def test_bound_search_dense_matches_reference(search_inputs, monkeypatch):
    """``ann_search`` with dense visited (``SEARCH_SMOKE`` with
    ``visited="dense"`` on both sides) returns the reference's ids and
    distances bit for bit."""
    x, q, g = search_inputs
    for mod in (r_rnnd_ann, rnnd_ann):
        monkeypatch.setattr(mod, "SEARCH_SMOKE",
                            dataclasses.replace(mod.SEARCH_SMOKE, visited="dense"))
    ref = rsteps.bind(rconfigs.get("rnnd-ann"), "search_1m", reduced=True)
    port = steps.bind("rnnd-ann", "search_1m", reduced=True, device="cpu")
    rids, rdists = ref.step_fn({}, _search_batch(x, q, g, False))
    ids, dists = port.step_fn({}, _search_batch(x, q, g, True))
    assert ids.shape == (128, 1) and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(dists.numpy().view(np.uint32),
                                  np.asarray(rdists).view(np.uint32))


def test_bound_search_hashed_matches_dense_oracle(search_inputs, monkeypatch):
    """``ann_search`` as bound (hashed visited) equals the port's dense
    oracle on the same inputs, and finds the reference's dense results."""
    x, q, g = search_inputs
    hashed = steps.bind("rnnd-ann", "search_1m", reduced=True, device="cpu")
    assert rnnd_ann.SEARCH_SMOKE.visited == "hashed"
    ids, dists = hashed.step_fn({}, _search_batch(x, q, g, True))
    monkeypatch.setattr(rnnd_ann, "SEARCH_SMOKE",
                        dataclasses.replace(rnnd_ann.SEARCH_SMOKE, visited="dense"))
    dense = steps.bind("rnnd-ann", "search_1m", reduced=True, device="cpu")
    dids, ddists = dense.step_fn({}, _search_batch(x, q, g, True))
    assert torch.equal(ids, dids) and torch.equal(dists, ddists)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("d", [24, 960])
def test_random_init_does_not_depend_on_the_gather_budget(metric, d, monkeypatch):
    """RandomGraph(S) drawn whole and in blocks of a few pairs (a budget
    that splits its pair gather into many blocks) is the same graph bit for
    bit, on a real-valued corpus; the pair distances equal the reference's
    ``gather_dists`` on an integer corpus."""
    n, s = 300, 8
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((n, d)).astype(np.float32))
    graphs = []
    for budget in (D.GATHER_BUDGET, 4 * d * 4 * 37):      # whole; blocks of 37 pairs
        monkeypatch.setattr(D, "GATHER_BUDGET", budget)
        graphs.append(G.random_init_graph(x, s, 16, metric, torch.Generator().manual_seed(7)))
    for a, b in zip(*graphs):
        assert torch.equal(a, b)
    xi = _int_corpus(d, n, d)
    u = np.random.default_rng(1).integers(-1, n, 500).astype(np.int32)
    v = np.random.default_rng(2).integers(-1, n, 500).astype(np.int32)
    want = np.asarray(RD.gather_dists(jnp.asarray(xi), jnp.asarray(u), jnp.asarray(v), metric))
    got = D.gather_dists(torch.from_numpy(xi), torch.from_numpy(u), torch.from_numpy(v), metric)
    if metric == "cos":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
