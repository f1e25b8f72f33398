"""The SQ8 index (``build_gist_sq8``: GIST1M's shape stored as per-dimension
int8 codes, Faiss's SQ8) on its normal path, at the reduced size on seeded
data: ``launch.steps.bind`` binds the int8 quantization, and its step is
``rnn_descent.build`` with that config bit for bit (the encode, then the
sweeps over the codes); the graph's listed distances are those of a float64
decode of the codes; the benchmark's plain codec
(``portbench/reference/sq8.py``) gives the program's codes to within one
step, and on exact ties the same code; a traced build equals the untraced
one and records the encode under ``quant/encode``."""
import os
import sys

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import rnnd_ann
from repro_torch.core import rnn_descent as rd
from repro_torch.launch import steps
from repro_torch.obs import trace
from repro_torch.quant import Quantization, encode_corpus, quantize_int8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import sq8 as ref_sq8  # noqa: E402

torch.set_num_threads(1)

N, D = 4096, 32            # bind(..., reduced=True)'s corpus


def _mixture(seed, n=N, d=D, clusters=16):
    gen = torch.Generator().manual_seed(seed)
    centres = 3 * torch.randn(clusters, d, generator=gen)
    pick = torch.randint(0, clusters, (n,), generator=gen)
    return centres[pick] + torch.randn(n, d, generator=gen)


def _same_graph(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.fixture(scope="module")
def built():
    x = _mixture(11)
    bound = steps.bind("rnnd-ann", "build_gist_sq8", reduced=True, device="cpu")
    g = bound.step_fn({}, {"x": x, "generator": torch.Generator().manual_seed(5)})
    return x, bound, g


@pytest.mark.parametrize("reduced", [False, True])
def test_bind_gives_the_int8_config(reduced):
    b = steps.bind("rnnd-ann", "build_gist_sq8", reduced=reduced, device="cpu")
    base = rnnd_ann.SMOKE if reduced else rnnd_ann.FULL
    assert b.kind == "ann_build" and b.shape.dims == {"n": 1_000_000, "d": 960}
    assert b.cfg.quant == Quantization("int8", rerank_k=64) == rnnd_ann.SQ8
    assert b.cfg.quant.mode == "int8" and b.cfg.quant.rerank_k == 64
    assert {f: getattr(b.cfg, f) for f in ("s", "r", "t1", "t2", "capacity", "chunk",
                                           "gram_dtype", "merge", "metric")} == \
        {f: getattr(base, f) for f in ("s", "r", "t1", "t2", "capacity", "chunk",
                                       "gram_dtype", "merge", "metric")}
    want = (N, D) if reduced else (1_000_000, 960)
    assert b.input_specs == {"x": (want, torch.float32)}
    # the f32 shapes keep their f32 configs
    assert steps.bind("rnnd-ann", "build_gist", reduced=reduced, device="cpu").cfg == base


def test_bound_step_is_rnn_descent_build_bit_for_bit(built):
    x, bound, g = built
    want = rd.build(x, bound.cfg, torch.Generator().manual_seed(5))
    assert _same_graph(g, want)
    f32 = rd.build(x, rnnd_ann.SMOKE, torch.Generator().manual_seed(5))
    assert not torch.equal(g.dists, f32.dists)        # the codes change the distances


def test_listed_distances_are_the_float64_decode_of_its_codes(built):
    x, bound, g = built
    qx = encode_corpus(x, bound.cfg.quant)
    x_hat = qx.codes.double() * qx.scale.double() + qx.zero.double()
    rows = torch.arange(N)[:, None].expand_as(g.neighbors)
    live = g.neighbors >= 0
    src, dst = rows[live], g.neighbors[live].long()
    exact = ((x_hat[src] - x_hat[dst]) ** 2).sum(1)
    rel = (g.dists[live].double() - exact).abs() / exact
    assert int(live.sum()) > N * 4
    assert float(rel.max()) < 1e-4    # f32 Gram sums; gist1m_sq8's graph_dist_rel_err
    xd = x.double()
    raw = ((xd[src] - xd[dst]) ** 2).sum(1)       # the f32 rows' distances are not listed
    assert float(((g.dists[live].double() - raw).abs() / raw).max()) > 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_encode_matches_quantize_int8_within_one_step(seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(3000, 48, generator=gen) * (1 + 10 * torch.rand(48, generator=gen)) \
        + 5 * torch.randn(48, generator=gen)
    qx = quantize_int8(x)
    scale, zero = ref_sq8.fit(x)
    want = ref_sq8.encode(x, scale, zero)
    assert ref_sq8.far_codes(qx.codes, want) == 0
    assert int((qx.codes.long() - want).abs().max()) <= 1
    assert float((qx.scale.double() - scale).abs().max()) <= 1e-7 * float(scale.max())
    decoded = ref_sq8.decode(qx.codes, scale, zero)
    # a code one step off sits on a tie: half a step from the row either way
    assert float(((decoded - x.double()).abs() / scale).max()) <= 0.5 + 1e-4


def test_reference_encode_matches_on_exact_ties():
    """Per dimension [-127/64, 127/64]: scale 1/64 and zero 0 exactly in
    both precisions, and every value (k + 1/2)/64 a tie that both round
    half to even; a code two steps off is counted."""
    k = torch.arange(-127, 127, dtype=torch.float32)
    ties = ((k + 0.5) / 64)[:, None].repeat(1, 8)
    ends = torch.full((2, 8), 127 / 64)
    ends[0] = -127 / 64
    x = torch.cat([ends, ties, -ties])
    qx = quantize_int8(x)
    scale, zero = ref_sq8.fit(x)
    assert torch.equal(scale, torch.full((8,), 1 / 64, dtype=torch.float64))
    assert torch.equal(zero, torch.zeros(8, dtype=torch.float64))
    want = ref_sq8.encode(x, scale, zero)
    assert torch.equal(qx.codes.long(), want)
    assert torch.equal(want[2:256, 0], torch.round(k + 0.5).long())   # halves to even
    off = qx.codes.clone()
    off[5, 3] += 2
    assert ref_sq8.far_codes(off, want) == 1


def test_traced_build_equals_untraced_and_records_the_encode(built):
    x, bound, g = built
    obs.reset()
    obs.enable(install_hooks=False)
    try:
        traced = bound.step_fn({}, {"x": x, "generator": torch.Generator().manual_seed(5)})
    finally:
        obs.disable()
    assert _same_graph(g, traced)
    evs = trace.events()
    enc = [e for e in evs if e["name"] == "quant/encode"]
    assert len(enc) == 1
    assert enc[0]["attrs"] == {"launches": 0, "rows": N, "d": D, "mode": "int8",
                               "code_bytes": N * D}
    first_sweep = min(e["start_s"] for e in evs if e["name"] == "rnn_descent/sweep")
    assert enc[0]["depth"] == 0 and enc[0]["start_s"] + enc[0]["dur_s"] <= first_sweep
    prunes = [e["attrs"] for e in evs if e["name"] == "rng_prune/rows"]
    assert len(prunes) == bound.cfg.t1 * bound.cfg.t2
    assert all(a["itemsize"] == 1 and a["d"] == D for a in prunes)


def test_f32_build_records_no_encode():
    x = _mixture(12, n=600)
    obs.reset()
    obs.enable(install_hooks=False)
    try:
        rd.build(x, rnnd_ann.SMOKE, torch.Generator().manual_seed(1))
    finally:
        obs.disable()
    assert not [e for e in trace.events() if e["name"] == "quant/encode"]
