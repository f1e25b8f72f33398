"""The port's CUDA kernels against their plain versions, on the card (f32,
bf16, int8 and PQ variants; the FM interaction, its gradient, the recsys
serve path and SMOKE train steps).

Marked ``cuda``: on a machine without a card every test skips. On the card
(no JAX there, so without the JAX conftest):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Integer-valued inputs make every l2/ip distance exact, so ids, keep masks and
redirects must match exactly; real-valued inputs are held to the stated
tolerances.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(x, m, gen):
    from repro_torch.core import graph as G
    g = G.random_init_graph(x, min(20, m), m, "l2", gen)
    flags = torch.randint(0, 2, g.flags.shape, generator=gen, device=x.device)
    return g.neighbors, g.dists, flags.to(torch.uint8)


@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rng_prune_exact_on_integer_data(dev, m, metric):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rng_prune import ops as R
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-8, 9, (2000, 32), generator=gen, device=dev).float()
    ids, dists, flags = _graph(x, m, gen)
    before = LAUNCHES["rng_prune"]
    ker = R.rng_prune(x, ids, dists, flags, metric)
    torch.cuda.synchronize()
    assert LAUNCHES["rng_prune"] == before + 1
    ref = R.rng_prune_plain(x, ids, dists, flags, metric)
    for a, b in zip(ker, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_rng_prune_real_data(dev, dtype, metric):
    """Gram sums in another order than the plain matmul: keep decisions may
    flip only where a pair distance ties the row distance to rounding."""
    from repro_torch.kernels.rng_prune import ops as R
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(4000, 128, generator=gen, device=dev)
    ids, dists, flags = _graph(x, 128, gen)
    xx = x.to(dtype)
    ker = R.rng_prune(xx, ids, dists, flags, metric)
    ref = R.rng_prune_plain(xx, ids, dists, flags, metric)
    assert float((ker[0] == ref[0]).float().mean()) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_matches_plain(dev, dtype, metric):
    from repro_torch.core.graph import key_dist
    from repro_torch.kernels.beam_score import ops as B
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(3000, 128, generator=gen, device=dev)
    nbrs = torch.randint(-1, 3000, (3000, 40), generator=gen, device=dev, dtype=torch.int32)
    u = torch.randint(0, 3000, (300,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randn(300, 128, generator=gen, device=dev)
    ids, d, keys = B.beam_score(x.to(dtype), nbrs, u, q, 32, metric)
    rids, rd, _ = B.beam_score_ref(x.to(dtype), nbrs, u, q, 32, metric)
    torch.testing.assert_close(ids, rids, rtol=0, atol=0)
    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(d))
    # l2 cancels: |q|^2 + |v|^2 - 2qv, so the error scales with the norms
    scale = (q * q).sum(1, keepdim=True) + 1.0 if metric != "cos" else 1.0
    assert float(((d - rd).abs() / scale)[fin].max()) <= 1e-5
    torch.testing.assert_close(key_dist(keys), d, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairwise_l2_matches_plain(dev, dtype):
    from repro_torch.kernels.pairwise_l2 import ops as P
    gen = torch.Generator(device=dev).manual_seed(3)
    for na, nb, d in ((300, 5000, 128), (7, 129, 3), (130, 1001, 33)):
        a = torch.randn(na, d, generator=gen, device=dev).to(dtype)
        b = torch.randn(nb, d, generator=gen, device=dev).to(dtype)
        out = P.pairwise_l2(a, b)
        ref = P.pairwise_l2_ref(a, b)
        af, bf = a.float(), b.float()
        scale = (af * af).sum(1)[:, None] + (bf * bf).sum(1)[None, :]
        assert float(((out - ref).abs() / scale).max()) <= 1e-5
    ai = torch.randint(-8, 9, (200, 64), generator=gen, device=dev).float()
    bi = torch.randint(-8, 9, (3000, 64), generator=gen, device=dev).float()
    torch.testing.assert_close(P.pairwise_l2(ai, bi), P.pairwise_l2_ref(ai, bi), rtol=0, atol=0)


def _int8_space(gen, n, d, dev, integer):
    if integer and d > 256:
        # a score of d terms stays an exact f32 integer below 2^24: at GIST's
        # d = 960 codes in [-8, 8], unit scale, integer zero
        codes = torch.randint(-8, 9, (n, d), generator=gen, device=dev).to(torch.int8)
        zero = torch.randint(-3, 4, (d,), generator=gen, device=dev).float()
        return codes, torch.ones(d, device=dev), zero
    codes = torch.randint(-127, 128, (n, d), generator=gen, device=dev).to(torch.int8)
    if integer:   # dyadic scale, integer zero: every decoded value and score exact
        scale = 2.0 ** -torch.randint(1, 4, (d,), generator=gen, device=dev).float()
        zero = torch.randint(-3, 4, (d,), generator=gen, device=dev).float()
    else:
        scale = torch.rand(d, generator=gen, device=dev) * 0.05 + 0.005
        zero = torch.randn(d, generator=gen, device=dev)
    return codes, scale, zero


def _with_bad_ids(nbrs, n, gen):
    """Plant ids outside [0, n) (the kernels read them as padding); returns
    (planted, what the plain version must see: -1 in their place)."""
    bad = torch.rand(nbrs.shape, generator=gen, device=nbrs.device) < 0.02
    planted = torch.where(bad, n + 5, nbrs).to(torch.int32)
    return planted, torch.where(bad, -1, nbrs).to(torch.int32)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_rng_prune_int8_matches_plain(dev, metric, m, integer):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rng_prune import ops as R
    from repro_torch.quant import int8_decode
    gen = torch.Generator(device=dev).manual_seed(4)
    codes, scale, zero = _int8_space(gen, 3000, 64, dev, integer)
    ids, dists, flags = _graph(int8_decode(codes, scale, zero), m, gen)
    planted, ids = _with_bad_ids(ids, 3000, gen)
    before = LAUNCHES["rng_prune_int8"]
    ker = R.rng_prune_int8(codes, scale, zero, planted, dists, flags, metric)
    torch.cuda.synchronize()
    assert LAUNCHES["rng_prune_int8"] == before + 1
    ref = R.rng_prune_int8_plain(codes, scale, zero, ids, dists, flags, metric)
    if integer and metric != "cos":
        for a, b in zip(ker, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    # f32 Gram sums in another order: keep/red_w may flip only at rounding ties
    assert float((ker[0] == ref[0]).float().mean()) >= 0.999
    assert float((ker[1] == ref[1]).float().mean()) >= 0.999
    same = (ker[1] == ref[1]) & (ker[1] >= 0)
    xh = int8_decode(codes, scale, zero)
    lim = 1e-5 * (2.0 if metric == "cos" else 2 * float((xh * xh).sum(1).max()))
    assert float((ker[2] - ref[2])[same].abs().max()) <= lim


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("d", [37, 128, 960])
@pytest.mark.parametrize("m", [50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_rng_prune_ragged_rows(dev, dtype, metric, m, d, integer):
    """One launch over rows of every extent a tile edge can get wrong (0, 1,
    31, 32, 33, 64, 65, 127, 128, capped at m), dense and with holes (-1 and
    ids >= n) below the last valid slot; d = 37 takes the unaligned gather,
    d = 960 is GIST1M's width (the SQ8 build's int8 prune).
    Integer-valued l2/ip: bit for bit the plain version; otherwise the
    agreement limits of the real-data tests."""
    import numpy as np
    from _ragged import ragged_rows

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rng_prune import ops as R
    from repro_torch.quant import int8_decode
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 3000
    if dtype == "int8":
        codes, scale, zero = _int8_space(gen, n, d, dev, integer)
        xv = int8_decode(codes, scale, zero)
    else:
        xv = (torch.randint(-8, 9, (n, d), generator=gen, device=dev).float() if integer
              else torch.randn(n, d, generator=gen, device=dev))
    planted, ids, dists, flags = (torch.from_numpy(a).to(dev) for a in
                                  ragged_rows(xv.cpu().numpy(), m, 6, metric, repeats=8))
    name = "rng_prune_int8" if dtype == "int8" else "rng_prune"
    before = LAUNCHES[name]
    if dtype == "int8":
        ker = R.rng_prune_int8(codes, scale, zero, planted, dists, flags, metric)
        ref = R.rng_prune_int8_plain(codes, scale, zero, ids, dists, flags, metric)
    else:
        xx = xv.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
        ker = R.rng_prune(xx, planted, dists, flags, metric)
        ref = R.rng_prune_plain(xx, ids, dists, flags, metric)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    assert int(ker[0].sum()) > 0
    if integer and metric != "cos":
        for a, b in zip(ker, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    assert float((ker[0] == ref[0]).float().mean()) >= 0.999
    assert float((ker[1] == ref[1]).float().mean()) >= 0.999
    same = (ker[1] == ref[1]) & (ker[1] >= 0)
    xf = xv.float()
    lim = 1e-5 * (2.0 if metric == "cos" else 2 * float((xf * xf).sum(1).max()))
    assert float((ker[2] - ref[2])[same].abs().max()) <= lim


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m", [129, 132, 160, 256])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rng_prune_wide_rows(dev, dtype, metric, m, integer):
    """The M <= 256 instance (NSG's rows are C = 132 wide): one launch over
    rows of every extent up to m, dense and with holes (-1 and ids >= n);
    integer-valued l2/ip bit for bit the plain version, otherwise the
    agreement limits of the real-data tests."""
    from _ragged import ragged_rows

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rng_prune import ops as R
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d = 3000, 128
    xv = (torch.randint(-8, 9, (n, d), generator=gen, device=dev).float() if integer
          else torch.randn(n, d, generator=gen, device=dev))
    planted, ids, dists, flags = (torch.from_numpy(a).to(dev) for a in
                                  ragged_rows(xv.cpu().numpy(), m, 8, metric, repeats=4))
    xx = xv.to(dtype)
    before = LAUNCHES["rng_prune"]
    ker = R.rng_prune(xx, planted, dists, flags, metric)
    ref = R.rng_prune_plain(xx, ids, dists, flags, metric)
    torch.cuda.synchronize()
    assert LAUNCHES["rng_prune"] == before + 1
    assert int(ker[0].sum()) > 0 and int((ker[1] >= 0).sum()) > 0
    if integer and metric != "cos":
        for a, b in zip(ker, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    assert float((ker[0] == ref[0]).float().mean()) >= 0.999
    assert float((ker[1] == ref[1]).float().mean()) >= 0.999
    same = (ker[1] == ref[1]) & (ker[1] >= 0)
    xf = xx.float()
    lim = 1e-5 * (2.0 if metric == "cos" else 2 * float((xf * xf).sum(1).max()))
    assert float((ker[2] - ref[2])[same].abs().max()) <= lim


def test_rng_prune_rejects_rows_past_its_limit(dev):
    """rng_prune takes rows of up to 256 candidates, rng_prune_int8 up to
    128; wider rows raise a ValueError naming the limit, on the card only
    (the plain versions, like the reference, take any width)."""
    from repro_torch.kernels.rng_prune import ops as R
    x = torch.zeros(300, 16, device=dev)
    codes = torch.zeros(300, 16, dtype=torch.int8, device=dev)
    one, zero = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    for m, limit, call, plain in (
            (257, 256, lambda i, d: R.rng_prune(x, i, d),
             lambda i, d: R.rng_prune_plain(x, i, d)),
            (129, 128, lambda i, d: R.rng_prune_int8(codes, one, zero, i, d),
             lambda i, d: R.rng_prune_int8_plain(codes, one, zero, i, d))):
        ids = torch.arange(m, dtype=torch.int32, device=dev)[None].repeat(4, 1)
        d = torch.zeros(4, m, device=dev)
        with pytest.raises(ValueError, match=f"M <= {limit}"):
            call(ids, d)
        call(ids[:, :limit], d[:, :limit])     # the limit itself launches
        plain(ids, d)                          # the plain version takes any width
    torch.cuda.synchronize()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_baselines_on_the_card_equal_the_cpu_route(dev, metric, monkeypatch):
    """A small NN-Descent (from one random initial graph) and the NSG-style
    stages on its graph, on the card and on the CPU, over an integer corpus:
    the same graphs bit for bit; NSG's prune launches rng_prune once a build
    (C = 40 through the M <= 128 instance, C = 132 through M <= 256)."""
    from repro_torch.core import graph as G
    from repro_torch.core import nn_descent as nnd
    from repro_torch.core import nsg_style as nsg
    from repro_torch.kernels import LAUNCHES, reset_launches
    gen = torch.Generator().manual_seed(11)
    x = torch.randint(-8, 9, (3000, 32), generator=gen).float()
    cfg = nnd.NNDescentConfig(k=24, s=8, iters=4, metric=metric)
    g0 = nnd.random_init(x, cfg, gen)
    monkeypatch.setattr(nnd, "JOIN_BUDGET", 50_000)   # several chunks a join
    out = {}
    for where in ("cpu", "cuda"):
        xd, g = x.to(where), G.Graph(*(t.to(where) for t in g0))
        for _ in range(cfg.iters):
            g = nnd.join_and_update(xd, g, cfg)
        reset_launches()
        graphs = [g] + [nsg.refine(xd, g, nsg.NSGStyleConfig(r=16, c=c, knn=cfg, metric=metric))
                        for c in (40, 132)]
        out[where] = [[t.cpu() for t in gg] for gg in graphs]
        if where == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["rng_prune"] == 2
    for a, b in zip(out["cpu"], out["cuda"]):
        for ta, tb in zip(a, b):
            torch.testing.assert_close(ta, tb, rtol=0, atol=0)


def _frontier(gen, n, m, b, dev):
    nbrs = torch.randint(-1, n, (n, m), generator=gen, device=dev, dtype=torch.int32)
    u = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
    return nbrs, u


def _hold(ker, ref, exact, scale):
    from repro_torch.core.graph import key_dist
    ids, d, keys = ker
    torch.testing.assert_close(ids, ref[0], rtol=0, atol=0)
    fin = torch.isfinite(ref[1])
    assert torch.equal(fin, torch.isfinite(d))
    if exact:
        torch.testing.assert_close(d, ref[1], rtol=0, atol=0)
        torch.testing.assert_close(keys, ref[2], rtol=0, atol=0)
    elif bool(fin.any()):     # a call may hold nothing but padding
        assert float(((d - ref[1]).abs() / scale)[fin].max()) <= 1e-5
    torch.testing.assert_close(key_dist(keys), d, rtol=0, atol=0)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_int8_matches_plain(dev, metric, m, integer):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.quant import int8_decode
    gen = torch.Generator(device=dev).manual_seed(5)
    n, d, b = 3000, 128, 300
    codes, scale, zero = _int8_space(gen, n, d, dev, integer)
    nbrs, u = _frontier(gen, n, m, b, dev)
    planted, nbrs = _with_bad_ids(nbrs, n, gen)
    q = (torch.randint(-8, 9, (b, d), generator=gen, device=dev).float() if integer
         else torch.randn(b, d, generator=gen, device=dev))
    before = LAUNCHES["beam_score_int8"]
    for k in (32, m + 7):    # k > M clamps to M
        ker = B.beam_score_int8(codes, scale, zero, planted, u, q, k, metric)
        ref = B.beam_score_int8_ref(codes, scale, zero, nbrs, u, q, k, metric)
        assert ker[0].shape == (b, min(k, m))
        xh = int8_decode(codes, scale, zero)
        scl = ((q * q).sum(1, keepdim=True) + float((xh * xh).sum(1).max())
               if metric != "cos" else 1.0)
        _hold(ker, ref, integer and metric != "cos", scl)
    torch.cuda.synchronize()
    assert LAUNCHES["beam_score_int8"] == before + 2


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("mq", [8, 32])
@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_pq_matches_plain(dev, metric, m, mq, integer):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.quant import pq_lut
    gen = torch.Generator(device=dev).manual_seed(6)
    n, d, b = 3000, 128, 300
    shape = (mq, 256, d // mq)
    cb = (torch.randint(-4, 5, shape, generator=gen, device=dev).float() if integer
          else torch.randn(shape, generator=gen, device=dev))
    q = (torch.randint(-4, 5, (b, d), generator=gen, device=dev).float() if integer
         else torch.randn(b, d, generator=gen, device=dev))
    codes = torch.randint(0, 256, (n, mq), generator=gen, device=dev).to(torch.uint8)
    nbrs, u = _frontier(gen, n, m, b, dev)
    planted, nbrs = _with_bad_ids(nbrs, n, gen)
    lut = pq_lut(q, cb, metric)
    before = LAUNCHES["beam_score_pq"]
    for k in (32, m + 7):
        ker = B.beam_score_pq(codes, planted, u, *lut, k, metric)
        ref = B.beam_score_pq_ref(codes, nbrs, u, *lut, k, metric)
        assert ker[0].shape == (b, min(k, m))
        # the terms are non-negative (l2) or signed partial dots (ip): error
        # scales with the sum of their magnitudes
        scl = lut[0].abs().amax(dim=2).sum(1, keepdim=True) if metric != "cos" else 1.0
        _hold(ker, ref, integer and metric != "cos", scl)
    torch.cuda.synchronize()
    assert LAUNCHES["beam_score_pq"] == before + 2


def _graph_rows(n, m, seed, dev):
    from _ragged import beam_rows
    return (torch.from_numpy(a).to(dev) for a in beam_rows(n, m, seed))


def _lanes(gen, n, b, dev):
    """b frontier ids in [0, n), with lanes 1, 2, 5 (and every 13th, 17th,
    19th after them) at -1, n and 2^31 - 1: retired or bad lanes."""
    u = torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
    u[1::13] = -1
    u[2::17] = n
    u[5::19] = 2**31 - 1
    return u


def _ks(m):
    return sorted({k for k in (1, 17, 32, 64, m) if k <= m})


def _misaligned(t, offset):
    """A contiguous copy of ``t`` whose data pointer is ``offset`` bytes past
    an allocation's start (offset 0: ``t`` itself)."""
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return flat[offset:].view(t.shape).copy_(t)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [37, 64, 128, 200, 960])
@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_int8_on_graph_shaped_rows(dev, metric, m, d, offset):
    """Valid-first rows of every valid count, holes, ids >= n, retired and
    bad frontier ids, each k and lane count; exact on an integer-valued code
    space. offset 1 (and d = 37, 200) takes the kernel's generic instance;
    d = 960 is the SQ8 GIST index's search."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.beam_score import ops as B
    from repro_torch.quant import int8_decode
    gen = torch.Generator(device=dev).manual_seed(7)
    n = 3000
    planted, nbrs = _graph_rows(n, m, m + d, dev)
    before, calls = LAUNCHES["beam_score_int8"], 0
    for integer in (True, False):
        codes, scale, zero = _int8_space(gen, n, d, dev, integer)
        codes = _misaligned(codes, offset)
        xh = int8_decode(codes, scale, zero)
        for b in (1, 300, 1024):
            u = _lanes(gen, n, b, dev)
            q = (torch.randint(-8, 9, (b, d), generator=gen, device=dev).float() if integer
                 else torch.randn(b, d, generator=gen, device=dev))
            scl = ((q * q).sum(1, keepdim=True) + float((xh * xh).sum(1).max())
                   if metric != "cos" else 1.0)
            for k in _ks(m):
                ker = B.beam_score_int8(codes, scale, zero, planted, u, q, k, metric)
                ref = B.beam_score_int8_ref(codes, scale, zero, nbrs, u, q, k, metric)
                _hold(ker, ref, integer and metric != "cos", scl)
                calls += 1
    torch.cuda.synchronize()
    assert LAUNCHES["beam_score_int8"] == before + calls


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [24, 37, 64, 96, 128, 200, 384, 960])
@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_score_on_graph_shaped_rows(dev, dtype, metric, m, d, offset):
    """f32 and bf16 rows: valid-first rows of every valid count, holes, ids
    >= n, retired and bad frontier ids, each k and lane count; exact on an
    integer-valued corpus and query (l2, ip). The widths reach every vector
    instance (groups of 8, 16 and 32 threads; one, two, four or eight
    16-byte pieces a thread: f32 d = 24 .. 960, bf16 d = 64 .. 960); d = 37,
    bf16 d = 24 (three pieces) and offset 1 (x shifted by one element) take
    the generic one."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.beam_score import ops as B
    gen = torch.Generator(device=dev).manual_seed(8)
    n = 3000
    planted, nbrs = _graph_rows(n, m, m + d, dev)
    before, calls = LAUNCHES["beam_score"], 0
    for integer in (True, False):
        x = (torch.randint(-8, 9, (n, d), generator=gen, device=dev).float() if integer
             else torch.randn(n, d, generator=gen, device=dev)).to(dtype)
        x = _misaligned(x, offset)
        xf = x.float()
        for b in (1, 300, 1024):
            u = _lanes(gen, n, b, dev)
            q = (torch.randint(-8, 9, (b, d), generator=gen, device=dev).float() if integer
                 else torch.randn(b, d, generator=gen, device=dev))
            scl = ((q * q).sum(1, keepdim=True) + float((xf * xf).sum(1).max())
                   if metric != "cos" else 1.0)
            for k in _ks(m):
                ker = B.beam_score(x, planted, u, q, k, metric)
                ref = B.beam_score_ref(x, nbrs, u, q, k, metric)
                _hold(ker, ref, integer and metric != "cos", scl)
                calls += 1
    torch.cuda.synchronize()
    assert LAUNCHES["beam_score"] == before + calls


def _pq_case(gen, n, mq, dsub, b, dev, integer, metric):
    from repro_torch.quant import pq_lut
    shape = (mq, 256, dsub)
    cb = (torch.randint(-4, 5, shape, generator=gen, device=dev).float() if integer
          else torch.randn(shape, generator=gen, device=dev))
    q = (torch.randint(-4, 5, (b, mq * dsub), generator=gen, device=dev).float() if integer
         else torch.randn(b, mq * dsub, generator=gen, device=dev))
    return pq_lut(q, cb, metric)


def _hold_pq(dev, metric, m, mq, dsub, offset, seed):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.beam_score import ops as B
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 3000
    planted, nbrs = _graph_rows(n, m, m + mq, dev)
    codes = _misaligned(torch.randint(0, 256, (n, mq), generator=gen, device=dev)
                        .to(torch.uint8), offset)
    before, calls = LAUNCHES["beam_score_pq"], 0
    for integer in (True, False):
        for b in (1, 300, 1024):
            u = _lanes(gen, n, b, dev)
            lut = _pq_case(gen, n, mq, dsub, b, dev, integer, metric)
            scl = lut[0].abs().amax(dim=2).sum(1, keepdim=True) if metric != "cos" else 1.0
            for k in _ks(m):
                ker = B.beam_score_pq(codes, planted, u, *lut, k, metric)
                ref = B.beam_score_pq_ref(codes, nbrs, u, *lut, k, metric)
                _hold(ker, ref, integer and metric != "cos", scl)
                calls += 1
    torch.cuda.synchronize()
    assert LAUNCHES["beam_score_pq"] == before + calls


@pytest.mark.parametrize("mq", [8, 16, 32, 64])
@pytest.mark.parametrize("m", [32, 50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_pq_on_graph_shaped_rows(dev, metric, m, mq):
    """As the int8 test, over PQ codes of mq subspaces: exact on integer
    tables."""
    _hold_pq(dev, metric, m, mq, 2, 0, 8)


@pytest.mark.parametrize("mq,offset", [(3, 0), (12, 0), (32, 3), (300, 0)])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_beam_score_pq_odd_code_rows(dev, metric, mq, offset):
    """Code rows that are not whole 8-byte pieces (mq 3, 12), an unaligned
    codes pointer, and mq > 256 (the generic instance)."""
    _hold_pq(dev, metric, 50, mq, 1, offset, 9)


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_coded_medium_path_on_the_card(dev, mode):
    from repro_torch.core import eval as E
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.quant import Quantization, encode_corpus
    gen = torch.Generator(device=dev).manual_seed(0)
    x, q = clustered_vectors(VectorDatasetSpec.sift_like(5000, 200), gen, dev)
    quant = Quantization(mode=mode, m=32)
    reset_launches()
    g = rd.build(x, rd.RNNDescentConfig(t1=2, t2=5, quant=quant),
                 torch.Generator(device=dev).manual_seed(1))
    qx = encode_corpus(x, quant)
    ids, _ = S.search_tiled(x, g, q, S.default_entry_point(x),
                            S.SearchConfig(l=64, k=64, topk=10, quant=quant), tile_b=128, qx=qx)
    torch.cuda.synchronize()
    prune = "rng_prune_int8" if mode == "int8" else "rng_prune"
    assert LAUNCHES[prune] == 10 and LAUNCHES[f"beam_score_{mode}"] > 0
    _, gt = E.ground_truth(x, q, k=10)
    assert E.recall_topk(ids, gt) >= 0.9


def test_medium_path_on_the_card(dev):
    from repro_torch.core import eval as E
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    gen = torch.Generator(device=dev).manual_seed(0)
    x, q = clustered_vectors(VectorDatasetSpec.sift_like(5000, 200), gen, dev)
    g = rd.build(x, rd.RNNDescentConfig(t1=2, t2=5), torch.Generator(device=dev).manual_seed(1))
    _, gt = E.ground_truth(x, q, k=10)
    ep = S.default_entry_point(x)
    cfg = S.SearchConfig(l=64, k=64, topk=10)
    ids, _ = S.search_tiled(x, g, q, ep, cfg, tile_b=128)
    dense, _ = S.search_tiled(x, g, q, ep, S.SearchConfig(l=64, k=64, topk=10, visited="dense"),
                              tile_b=128)
    assert E.recall_topk(ids, gt) >= 0.95
    assert E.recall_topk(ids, gt) == E.recall_topk(dense, gt)


# --------------------------------------------------------------- bucket_merge
def _crafted_merge_input(n, m, metric, seed):
    """Prune outputs that hold every case the merge kernels must get right:
    rows of unique ids in [0, n) with -1 holes, rows offered no candidate
    (the last eighth), ids sharing a bucket, candidates already in their
    target row at another distance (n is small against m), self-loops,
    w >= n, NaN, +-inf and -0.0 distances in the rows and the redirects, and
    ties; ``ip`` distances are mostly negative."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.full((n, m), -1, dtype=torch.int32)
    for u in range(n):
        k = min(int(torch.randint(0, m + 1, (1,), generator=gen)), n)
        ids[u, :k] = torch.randperm(n, generator=gen)[:k].int()
        ids[u] = ids[u][torch.randperm(m, generator=gen)]
    lo = -6 if metric == "ip" else 0

    def values():
        return torch.randint(lo, 6, (n, m), generator=gen).float() / 2

    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0,
                            torch.tensor(-1, dtype=torch.int32).view(torch.float32).item()])

    def sprinkle(t, share):
        pick = torch.randint(0, len(special), t.shape, generator=gen)
        return torch.where(torch.rand(t.shape, generator=gen) < share, special[pick], t)

    dists = torch.where(ids >= 0, sprinkle(values(), 0.05), torch.tensor(float("inf")))
    red_d = sprinkle(values(), 0.1)
    keep = torch.rand((n, m), generator=gen) < 0.4
    red_w = torch.randint(-1, n + 3, (n, m), generator=gen).int()
    red_w = torch.where(torch.rand((n, m), generator=gen) < 0.05, ids, red_w)
    red_w = torch.where(keep | (torch.rand((n, m), generator=gen) < 0.3), -1, red_w)
    red_w = torch.where(((red_w >= 7 * n // 8) & (red_w < n)), -1, red_w)
    return ids, dists, keep, red_w, red_d


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_buckets", [16, 64, 256, 1024])
@pytest.mark.parametrize("m", [32, 128])
def test_bucket_merge_on_crafted_rows(dev, m, n_buckets, metric):
    """The two kernels equal the plain path (``ref.py``) bit for bit in
    neighbors, dists and flags, and in the count of real candidates, at cap
    m and at a cap below m: the plain path on the CPU for every input; on
    the card once each NaN is the positive one, since ``torch.sort`` on
    CUDA orders a NaN with its sign bit set before -inf (the CPU's sort puts
    every NaN last; a NaN is never live, in the kernels either)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.bucket_merge import ops as BM
    crafted = _crafted_merge_input(600, m, metric, seed=m + n_buckets)
    positive_nan = [t.nan_to_num(float("nan"), float("inf"), -float("inf"))
                    if t.dtype == torch.float32 else t for t in crafted]
    for cap in (m, m // 2 + 3):
        for ins, oracle_dev in ((crafted, "cpu"), (positive_nan, dev)):
            before = LAUNCHES["bucket_row_merge"]
            got, count = BM.bucket_merge(*(t.to(dev) for t in ins), n_buckets, cap)
            torch.cuda.synchronize()
            assert LAUNCHES["bucket_row_merge"] == before + 1
            want, want_count = BM.bucket_merge_ref(*(t.to(oracle_dev) for t in ins), n_buckets,
                                                   cap)
            assert _same_bits([t.cpu() for t in got], [t.cpu() for t in want])
            assert int(count) == int(want_count) > 0
        rows = slice(7 * 600 // 8, 600)          # offered no candidate
        assert int((got.neighbors[rows] >= 0).sum()) <= int((ins[0][rows] >= 0).sum())


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("m", [32, 128])
def test_bucket_merge_on_a_sweep(dev, m, metric):
    """On a real sweep's prune output (a clustered corpus after three sweeps):
    bit for bit the plain path."""
    from repro_torch.core import rnn_descent as rd
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels.bucket_merge import ops as BM
    gen = torch.Generator(device=dev).manual_seed(5)
    x, _ = clustered_vectors(VectorDatasetSpec.sift_like(6000, 10), gen, dev)
    cfg = rd.RNNDescentConfig(s=16, r=m // 2, t1=1, t2=3, capacity=m, metric=metric)
    g = rd.random_init(x, cfg, gen)
    for _ in range(3):
        g = rd.update_neighbors(x, g, cfg)
    keep, red_w, red_d = rd.prune_rows(x, g.neighbors, g.dists, g.flags, cfg)
    b = 2 * m
    got = BM.bucket_merge(g.neighbors, g.dists, keep, red_w, red_d, b)
    want = BM.bucket_merge_ref(g.neighbors, g.dists, keep, red_w, red_d, b)
    assert _same_bits(got[0], want[0]) and int(got[1]) == int(want[1]) > 0


def test_bucket_merge_raises_outside_its_limits_on_the_card(dev):
    """On the card the wrapper launches the kernels or raises: more buckets
    than the kernels' 2048, or rows wider than 256, never fall back to the
    plain version."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.bucket_merge import ops as BM
    for m, b in ((32, 4096), (257, 512)):
        ins = [t.to(dev) for t in _crafted_merge_input(64, m, "l2", seed=1)]
        before = dict(LAUNCHES)
        with pytest.raises(ValueError, match="outside the kernels' limits"):
            BM.bucket_merge(*ins, b)
        assert LAUNCHES == before


def test_build_with_the_bucket_merge_kernels_equals_the_plain_merge_on_the_card(dev, monkeypatch):
    """The medium build of ``test_medium_path_on_the_card``: with the merge
    kernels (two launches a sweep) the graph is the plain merge's, bit for
    bit."""
    from repro_torch.core import rnn_descent as rd
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.bucket_merge import ops as BM
    gen = torch.Generator(device=dev).manual_seed(0)
    x, _ = clustered_vectors(VectorDatasetSpec.sift_like(5000, 200), gen, dev)
    cfg = rd.RNNDescentConfig(t1=2, t2=5)
    reset_launches()
    g = rd.build(x, cfg, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    assert LAUNCHES["bucket_scatter"] == LAUNCHES["bucket_row_merge"] == cfg.t1 * cfg.t2
    monkeypatch.setattr(BM, "bucket_merge", BM.bucket_merge_ref)
    reset_launches()
    plain = rd.build(x, cfg, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    assert LAUNCHES["bucket_scatter"] == LAUNCHES["bucket_row_merge"] == 0
    assert _same_bits(g, plain)


def test_sq8_build_through_bind_on_the_card(dev):
    """``bind("rnnd-ann", "build_gist_sq8")`` on a 12,288 x 960 mixture (the
    FULL sweeps): traced and untraced bit for bit; 60 ``rng_prune_int8``
    launches and no f32 prune, 60 + 60 merge launches, one ``quant/encode``
    span with its device time; the listed distances those of a float64
    decode of the codes; a coded search over them with the f32 rerank."""
    from repro_torch import obs
    from repro_torch.core import search as S
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.obs import trace
    from repro_torch.quant import encode_corpus
    gen = torch.Generator(device=dev).manual_seed(9)
    n, d = 12_288, 960
    centres = torch.randn(64, d, generator=gen, device=dev)
    x = centres[torch.randint(0, 64, (n,), generator=gen, device=dev)] + \
        torch.randn(n, d, generator=gen, device=dev)
    q = centres[:16] + torch.randn(16, d, generator=gen, device=dev)
    bound = steps.bind("rnnd-ann", "build_gist_sq8", device=dev)
    sweeps = bound.cfg.t1 * bound.cfg.t2

    def build():
        return bound.step_fn({}, {"x": x, "generator": torch.Generator(device=dev).manual_seed(1)})

    reset_launches()
    g = build()
    torch.cuda.synchronize()
    assert (LAUNCHES["rng_prune_int8"], LAUNCHES["rng_prune"]) == (sweeps, 0)
    assert LAUNCHES["bucket_scatter"] == LAUNCHES["bucket_row_merge"] == sweeps
    obs.reset()
    try:
        with trace.enabled_scope():
            traced = build()
        evs = trace.events()
    finally:
        obs.disable()
    assert _same_bits(g, traced)
    (enc,) = [e for e in evs if e["name"] == "quant/encode"]
    assert enc["attrs"]["device_ms"] > 0 and enc["attrs"]["code_bytes"] == n * d
    prunes = [e["attrs"] for e in evs if e["name"] == "rng_prune/rows"]
    assert len(prunes) == sweeps and all(a["launches_rng_prune_int8"] == 1 and
                                         a["itemsize"] == 1 for a in prunes)
    qx = encode_corpus(x, bound.cfg.quant)
    x_hat = qx.codes.double() * qx.scale.double() + qx.zero.double()
    live = g.neighbors >= 0
    src = torch.arange(n, device=dev)[:, None].expand_as(g.neighbors)[live]
    exact = ((x_hat[src] - x_hat[g.neighbors[live].long()]) ** 2).sum(1)
    assert float(((g.dists[live].double() - exact).abs() / exact).max()) < 1e-4
    scfg = S.SearchConfig(l=128, k=64, max_iters=256, topk=10, quant=bound.cfg.quant)
    before = LAUNCHES["beam_score_int8"]
    ids, dists = S.search_tiled(x, g, q, S.default_entry_point(x), scfg, tile_b=16, qx=qx)
    assert LAUNCHES["beam_score_int8"] > before
    exact_q = ((x[ids.long()].double() - q[:, None].double()) ** 2).sum(-1)
    assert float(((dists.double() - exact_q).abs() / exact_q).max()) < 1e-5


# ---------------------------------------------------------------- fm_interact
# B not a multiple of any tile (1, 257, 262147) and D above the block (300)
FM_SWEEP = [(4, 3, 8), (512, 39, 10), (1000, 40, 32), (64, 26, 128), (1, 39, 10),
            (257, 39, 10), (262147, 39, 10), (33, 5, 300)]


def _fm_scale(e):
    """Magnitude bound of both sum-square terms per row: 0.5 sum_d (sum_f |e|)^2."""
    return 0.5 * (e.double().abs().sum(1) ** 2).sum(-1) + 1e-30


@pytest.mark.parametrize("b,f,d", FM_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_interact_matches_plain_and_pairs(dev, b, f, d, dtype):
    """Kernel against its plain version on the same tensor and against an
    f64 explicit-pairs oracle on up to 4096 rows, each within 1e-5 of the
    row's magnitude bound (f32 sums in another order)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.fm_interact import ops as FM
    gen = torch.Generator(device=dev).manual_seed(b + f + d)
    e = torch.randn(b, f, d, generator=gen, device=dev).to(dtype)
    before = LAUNCHES["fm_interact"]
    ker = FM.fm_interact(e)
    torch.cuda.synchronize()
    assert LAUNCHES["fm_interact"] == before + 1
    assert ker.shape == (b,) and ker.dtype == torch.float32
    scale = _fm_scale(e)
    assert float(((ker.double() - FM.fm_interact_ref(e).double()).abs() / scale).max()) <= 1e-5
    rows = torch.randperm(b, generator=gen, device=dev)[:4096]
    e64 = e[rows].double()
    gram = torch.bmm(e64, e64.transpose(1, 2))
    pairs = 0.5 * (gram.sum((1, 2)) - gram.diagonal(dim1=1, dim2=2).sum(-1))
    assert float(((ker[rows].double() - pairs).abs() / scale[rows]).max()) <= 1e-5


def test_fm_interact_empty_and_strided(dev):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.fm_interact import ops as FM
    before = LAUNCHES["fm_interact"]
    out = FM.fm_interact(torch.zeros((0, 39, 10), device=dev, dtype=torch.bfloat16))
    assert out.shape == (0,) and out.device.type == "cuda"
    assert LAUNCHES["fm_interact"] == before
    gen = torch.Generator(device=dev).manual_seed(3)
    view = torch.randn(300, 10, 39, generator=gen, device=dev).transpose(1, 2)
    torch.testing.assert_close(FM.fm_interact(view), FM.fm_interact(view.contiguous()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch_id", ["fm", "deepfm", "wide-deep", "xdeepfm"])
def test_recsys_serve_on_the_card(dev, arch_id):
    """One forward launches fm_interact once for FM and DeepFM and never for
    Wide&Deep and xDeepFM; the kernel and plain routes differ only in the FM
    term (1e-5 of its row bound, plus 1e-6 for the logit sum); the card and
    the CPU run the same weights and batch within 1e-2 (bf16 products
    accumulate in another order there: one-ulp flips, 2^-8 relative, in the
    tower)."""
    from repro_torch.configs import base as cb
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.fm_interact import ops as FM
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rs
    gen = torch.Generator(device=dev).manual_seed(0)
    bound = steps.bind(arch_id, "serve_p99", reduced=True, device=dev)
    params = bound.init_fn(gen)
    batch = cb.recsys_smoke_batch(gen, bound.cfg, bound.shape, dev)
    reset_launches()
    logit = rs.forward(params, batch, bound.cfg)
    torch.cuda.synchronize()
    uses_fm = bound.cfg.interaction in ("fm", "fm-2way")
    assert LAUNCHES["fm_interact"] == int(uses_fm)
    assert sum(LAUNCHES.values()) == LAUNCHES["fm_interact"]
    scores = bound.step_fn(params, batch)
    assert bool(((scores >= 0) & (scores <= 1)).all()) and bool(torch.isfinite(logit).all())
    if uses_fm:
        emb, _ = rs._field_embed(params, batch, bound.cfg)
        orig = FM.fm_interact
        FM.fm_interact = FM.fm_interact_ref
        try:
            plain = rs.forward(params, batch, bound.cfg)
        finally:
            FM.fm_interact = orig
        lim = 1e-5 * _fm_scale(emb) + 1e-6
        assert bool(((logit.double() - plain.double()).abs() <= lim).all())
    cpu = rs.forward(_to_cpu(params), _to_cpu(batch), bound.cfg)
    torch.testing.assert_close(logit.cpu(), cpu, rtol=0, atol=1e-2)


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_gradient_through_the_kernel_matches_the_plain_route(dev, dtype):
    """The fm_interact Function on the card: one kernel launch forward, the
    closed-form backward; its gradient against autograd through the plain
    version on the same embeddings, within one rounding to the dtype (f32:
    1e-6 of the row scale |g| sum_f |e|)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.fm_interact import ops as FM
    gen = torch.Generator(device=dev).manual_seed(11)
    e = torch.randn(4096, 39, 10, generator=gen, device=dev).to(dtype).requires_grad_(True)
    g = torch.randn(4096, generator=gen, device=dev)
    before = LAUNCHES["fm_interact"]
    (ker,) = torch.autograd.grad(FM.fm_interact(e), e, g)
    torch.cuda.synchronize()
    assert LAUNCHES["fm_interact"] == before + 1 and ker.dtype == dtype
    (plain,) = torch.autograd.grad(FM.fm_interact_ref(e), e, g)
    err = (ker.float() - plain.float()).abs()
    if dtype == torch.float32:
        scale = g.abs()[:, None, None] * e.detach().abs().sum(1, keepdim=True) + 1e-30
        assert float((err / scale).max()) <= 1e-6
    else:
        assert bool((err <= 2**-7 * plain.float().abs() + 1e-30).all())


def _state_to(state, dev):
    from repro_torch.checkpoint.checkpoint import flatten, unflatten
    return unflatten(state, (x.to(dev, copy=True) for _, x in flatten(state)))


@pytest.mark.parametrize("arch_id", ["deepfm", "minitron-4b", "deepseek-moe-16b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch_id):
    """One bound SMOKE train step on the card against the same step on the
    CPU from the same state and batch. DeepFM launches fm_interact once.
    The loss within 1e-2 relative and the grad norm within 5e-2 (bf16
    products accumulate in another order on the card); each weight within
    2.05 lr (Adam's first step can flip the sign of a rounding-noise
    gradient) plus a bf16 ulp of it (2^-7 |w|) for the bf16 leaves."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.configs import base as cb
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    cpu = torch.device("cpu")
    bc = steps.bind(arch_id, "train_batch" if arch_id == "deepfm" else "train_4k",
                    reduced=True, device=cpu)
    bg = steps.bind(arch_id, bc.shape.name, reduced=True, device=dev)
    state_c = bc.init_fn(torch.Generator().manual_seed(5))
    state_g = _state_to(state_c, dev)
    smoke = cb.recsys_smoke_batch if arch_id == "deepfm" else cb.lm_smoke_batch
    batch_c = smoke(torch.Generator().manual_seed(6), bc.cfg, bc.shape, cpu)
    batch_g = {k: v.to(dev) for k, v in batch_c.items()}
    reset_launches()
    state_g, mg = bg.step_fn(state_g, batch_g)
    torch.cuda.synchronize()
    assert LAUNCHES["fm_interact"] == int(arch_id == "deepfm")
    state_c, mc = bc.step_fn(state_c, batch_c)
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-2)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]), rel=5e-2)
    lr = float(mc["lr"])
    for (name, a), (_, b) in zip(flatten(state_g.params), flatten(state_c.params)):
        a, b = a.cpu().float(), b.float()
        lim = 2.05 * lr + 2**-22 * b.abs() + (2**-7 * b.abs() if "layers" in name else 0)
        assert bool(((a - b).abs() <= lim + 1e-12).all()), name


def test_score_candidates_ties_on_the_card(dev):
    """Integer-valued embeddings: exact scores, many ties, lower index first,
    the same top-100 as on the CPU."""
    from repro_torch.models import recsys as rs
    gen = torch.Generator(device=dev).manual_seed(4)
    cand = torch.randint(-2, 3, (100_000, 10), generator=gen, device=dev).float()
    q = torch.randint(-2, 3, (10,), generator=gen, device=dev).float()
    top, idx = rs.score_candidates(q, cand, k=100)
    ctop, cidx = rs.score_candidates(q.cpu(), cand.cpu(), k=100)
    assert torch.equal(idx.cpu(), cidx) and torch.equal(top.cpu(), ctop)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m", [50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("layout", ["sentinel tail", "scattered", "all empty"])
def test_rng_prune_on_frontier_blocks(dev, layout, metric, m, integer):
    """The streaming sweeps' prune input: a block of frontier rows, most of
    them sentinel rows (all -1: extent 0), the rest of every extent up to M
    (tests/_ragged.py, with holes); the live rows first and the sentinel
    tail after them, as the sorted frontier lays them out, or scattered, or
    none live. One launch; integer-valued: bit for bit the plain version,
    else its agreement limits; a sentinel row keeps nothing and redirects
    nothing."""
    import numpy as np
    from _ragged import ragged_rows

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rng_prune import ops as R
    gen = torch.Generator(device=dev).manual_seed(8)
    n, d = 3000, 64
    xv = (torch.randint(-8, 9, (n, d), generator=gen, device=dev).float() if integer
          else torch.randn(n, d, generator=gen, device=dev))
    planted, ids, dists, flags = (torch.from_numpy(a).to(dev) for a in
                                  ragged_rows(xv.cpu().numpy(), m, 9, metric, repeats=4))
    live = planted.shape[0] if layout != "all empty" else 0
    f = 8 * planted.shape[0]
    rows = {"sentinel tail": torch.arange(live, device=dev),
            "scattered": torch.randperm(f, generator=gen, device=dev)[:live],
            "all empty": torch.arange(0, device=dev)}[layout]

    def block(src, fill, dtype):
        out = torch.full((f, m), fill, dtype=dtype, device=dev)
        out[rows] = src[:live]
        return out
    bp, bi = block(planted, -1, torch.int32), block(ids, -1, torch.int32)
    bd, bf = block(dists, float("inf"), torch.float32), block(flags, 0, torch.uint8)
    before = LAUNCHES["rng_prune"]
    ker = R.rng_prune(xv, bp, bd, bf, metric)
    ref = R.rng_prune_plain(xv, bi, bd, bf, metric)
    torch.cuda.synchronize()
    assert LAUNCHES["rng_prune"] == before + 1
    empty = (bi < 0).all(1)
    assert not ker[0][empty].any() and (ker[1][empty] == -1).all()
    assert torch.isinf(ker[2][empty]).all()
    if integer:
        for a, b in zip(ker, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    assert float((ker[0] == ref[0]).float().mean()) >= 0.999
    assert float((ker[1] == ref[1]).float().mean()) >= 0.999


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_streaming_on_the_card_equals_the_cpu_route(dev, metric, monkeypatch):
    """StreamingANN over an integer corpus on the card and on the CPU route:
    insert (growing the store), delete, insert, a masked search, compact
    and its repair sweep give the same stores, slots, remap and results bit
    for bit. The seeding search runs dense-visited on both routes (which
    of two ids racing for one hashed slot wins differs between devices).
    Each insert prunes twice (its sweeps), each delete and the repair sweep
    once, all through rng_prune on the card."""
    import dataclasses

    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.core import graph as G
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.streaming import StreamingANN
    from repro_torch.streaming import store as ST
    from repro_torch.streaming import updates as U
    gen = torch.Generator().manual_seed(12)
    x = torch.randint(-8, 9, (1600, 24), generator=gen).float()
    cfg = U.StreamingConfig(
        build=rd.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128,
                                  metric=metric),
        seed_l=32, seed_k=12, seed_iters=64, batch_k=4, splice_k=6)
    scfg = S.SearchConfig(l=32, k=16, max_iters=96, topk=10, metric=metric, visited="dense")
    g0 = rd.build(x[:1200], cfg.build, torch.Generator().manual_seed(1))
    orig = U.StreamingConfig.seed_search_cfg
    monkeypatch.setattr(U.StreamingConfig, "seed_search_cfg",
                        lambda self: dataclasses.replace(orig(self), visited="dense"))
    out = {}
    for where in ("cpu", "cuda"):
        ann = StreamingANN(ST.from_built(x[:1200].to(where), G.Graph(*(t.to(where) for t in g0))),
                           cfg)
        reset_launches()
        s1 = ann.insert(x[1200:1400].to(where))
        ann.delete(torch.arange(100, 300))
        s2 = ann.insert(x[1400:1600].to(where))
        ids, dists = ann.search(x[1250:1450].to(where), scfg)
        remap = ann.compact(repair_sweeps=1)
        if where == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["rng_prune"] == 2 + 1 + 2 + 1 and LAUNCHES["beam_score"] > 0
        out[where] = (s1, s2, remap, ids.cpu(), dists.cpu(),
                      [leaf.cpu() for _, leaf in flatten(ann.store)])
    for a, b in zip(out["cpu"][:3], out["cuda"][:3]):
        assert (a == b).all()
    for a, b in zip(out["cpu"][3:5], out["cuda"][3:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(out["cpu"][5], out["cuda"][5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------- serving
def test_staging_ring_under_a_busy_stream(dev):
    """Three stage() calls on a ring of two pinned buffers while a long
    kernel holds the stream: the copies queue behind it, so the third
    stage() must wait for the first buffer's copy before rewriting it, and
    every tile keeps its own rows."""
    import numpy as np

    from repro_torch.serving import DoubleBuffer
    db = DoubleBuffer(tile_lanes=64, d=128, depth=2, device=dev)
    tiles = [[np.full((128,), 100.0 * t + i, np.float32) for i in range(64 - 5 * t)]
             for t in range(3)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)           # ~0.1 s of one SM's clock on the stream
    out = [db.stage(rows) for rows in tiles]
    torch.cuda.synchronize()
    for t, (rows, blk) in enumerate(zip(tiles, out)):
        assert blk.device.type == "cuda"
        assert torch.equal(blk[:len(rows)].cpu(), torch.from_numpy(np.stack(rows))), t
        assert (blk[len(rows):] == 0).all(), t
    assert db.lane_mask(7).device.type == "cuda" and int(db.lane_mask(7).sum()) == 7


def _serving_store(dev, quant=None, d=24):
    """A StreamingANN on ``dev`` over a clustered corpus (n = 2000), with
    int8 or PQ codes (dsub = 6 at d = 24, 4 otherwise) when ``quant`` names
    them."""
    from repro_torch.core import rnn_descent as rd
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    from repro_torch.quant import Quantization
    from repro_torch.streaming import StreamingANN, StreamingConfig
    gen = torch.Generator(device=dev).manual_seed(3)
    x, q = clustered_vectors(VectorDatasetSpec("serve", n=2000, d=d, n_queries=150,
                                               n_clusters=8), gen, dev)
    cfg = StreamingConfig(build=rd.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24),
                          seed_l=32, seed_k=12, seed_iters=64, batch_k=4, splice_k=6)
    ann = StreamingANN.from_corpus(x[:1800], cfg, torch.Generator(device=dev).manual_seed(1),
                                   device=dev)
    q_mode = None
    if quant is not None:
        q_mode = Quantization(mode=quant, m=4 if d == 24 else d // 4, rerank_k=32) \
            if quant == "pq" else Quantization(mode=quant, rerank_k=32)
        ann.quantize(q_mode)
    return ann, x.cpu().numpy(), q.cpu().numpy(), q_mode


@pytest.mark.parametrize("d", [24, 128])
@pytest.mark.parametrize("quant", [None, "int8", "pq"])
def test_serving_results_independent_of_coalescing_on_the_card(dev, quant, d):
    """Dense visited: every request's (ids, dists) equal bit for bit at tile
    widths 64, 16 and 7 (deadline-triggered partial tiles included)."""
    import numpy as np

    from repro_torch.core import search as S
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.quant import Quantization
    from repro_torch.serving import (AdmissionConfig, ServingConfig, ServingFrontend,
                                     WriterConfig)
    ann, _, q, q_mode = _serving_store(dev, quant, d)
    scfg = S.SearchConfig(l=32, k=16, max_iters=96, topk=10, visited="dense",
                          quant=q_mode or Quantization())
    out = {}
    reset_launches()
    for lanes in (64, 16, 7):
        t = [0.0]
        fe = ServingFrontend(ann, ServingConfig(
            admission=AdmissionConfig(tile_lanes=lanes, deadline_s=0.05),
            writer=WriterConfig(4, 4), search=scfg), clock=lambda: t[0])
        rids = []
        for i, row in enumerate(q):
            rids.append(fe.submit(row))
            t[0] += 0.002
            fe.pump()
        fe.drain()
        out[lanes] = [fe.result(r) for r in rids]
    torch.cuda.synchronize()
    name = f"beam_score_{quant}" if quant else "beam_score"
    assert LAUNCHES[name] > 0
    for lanes in (16, 7):
        for i, ((a, ad), (b, bd)) in enumerate(zip(out[64], out[lanes])):
            assert np.array_equal(a, b) and np.array_equal(ad, bd), (lanes, i)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_fixed_order_scores_do_not_depend_on_the_batch(dev, metric):
    """The search's seeds and rerank (score_lanes) and the PQ tables
    (pq_lut): every lane's values equal bit for bit whether it is scored in
    a batch of 1024, 64, 7 or alone, at d = 128 on real-valued data."""
    from repro_torch.kernels.beam_score.ref import score_lanes
    from repro_torch.quant import pq_lut
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = torch.randn(1024, 48, 128, generator=gen, device=dev)
    q = torch.randn(1024, 128, generator=gen, device=dev)
    cb = torch.randn(32, 256, 4, generator=gen, device=dev)
    whole = score_lanes(rows, q, metric), *pq_lut(q, cb, metric)
    for b in (64, 7, 1):
        part = score_lanes(rows[:b], q[:b], metric), *pq_lut(q[:b], cb, metric)
        for i, (a, p) in enumerate(zip(whole, part)):
            if i == 2:                       # lut_b: the codebooks' own, no lanes
                assert torch.equal(a, p)
            else:
                assert torch.equal(a[:b], p), (b, i)


def test_serving_epoch_pinning_on_the_card(dev):
    """A commit between a tile's dispatch and its harvest: the tile's
    results equal a direct search of the store it was dispatched against."""
    import numpy as np

    from repro_torch.core import search as S
    from repro_torch.serving import (AdmissionConfig, ServingConfig, ServingFrontend,
                                     WriterConfig)
    from repro_torch.streaming import store as ST
    ann, _, q, _ = _serving_store(dev)
    scfg = S.SearchConfig(l=32, k=16, max_iters=96, topk=10, visited="dense")
    lanes = 8
    fe = ServingFrontend(ann, ServingConfig(admission=AdmissionConfig(tile_lanes=lanes),
                                            writer=WriterConfig(8, 8), search=scfg,
                                            pipeline_depth=2), clock=lambda: 0.0)
    epoch0, st0 = ann.snapshot()
    rids = [fe.submit(row) for row in q[:lanes]]
    fe.pump()
    assert len(fe._inflight) == 1
    fe.submit_delete(np.arange(0, 8))
    fe.writer.commit()
    assert ann.epoch == epoch0 + 1
    fe.drain(flush_writes=False)
    eps = S.default_entry_point(st0.x, scfg.metric, valid=ST.active_mask(st0))
    want_ids, want_d = ann.search(torch.from_numpy(q[:lanes]).to(dev), scfg, entry_points=eps,
                                  tile_b=lanes, store=st0)
    for lane, rid in enumerate(rids):
        ids, dists = fe.result(rid)
        assert np.array_equal(ids, want_ids[lane].cpu().numpy())
        assert np.array_equal(dists, want_d[lane].cpu().numpy())
    assert fe.telemetry.summary()["staleness_max"] >= 1


def test_serving_session_on_the_card_equals_the_cpu_route(dev, monkeypatch):
    """One session with inserts and deletes under a manual clock, over an
    integer corpus, dense visited (the seeding searches too): every
    request's result, the final store and the telemetry counts equal on the
    card and on the CPU route; the card's session launched beam_score and
    rng_prune."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.core import graph as G
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import (AdmissionConfig, ServingConfig, ServingFrontend,
                                     WriterConfig)
    from repro_torch.streaming import StreamingANN
    from repro_torch.streaming import store as ST
    from repro_torch.streaming import updates as U
    gen = torch.Generator().manual_seed(21)
    x = torch.randint(-8, 9, (1400, 24), generator=gen).float()
    q = torch.randint(-8, 9, (90, 24), generator=gen).float().numpy()
    cfg = U.StreamingConfig(
        build=rd.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128),
        seed_l=32, seed_k=12, seed_iters=64, batch_k=4, splice_k=6)
    g0 = rd.build(x[:1200], cfg.build, torch.Generator().manual_seed(1))
    orig = U.StreamingConfig.seed_search_cfg
    monkeypatch.setattr(U.StreamingConfig, "seed_search_cfg",
                        lambda self: dataclasses.replace(orig(self), visited="dense"))
    scfg = S.SearchConfig(l=32, k=16, max_iters=96, topk=10, visited="dense")
    pool = x[1200:].numpy()
    out = {}
    for where in ("cpu", "cuda"):
        st = ST.grow(ST.from_built(x[:1200].to(where), G.Graph(*(t.to(where) for t in g0))),
                     1400)
        ann = StreamingANN(st, cfg)
        t = [0.0]
        fe = ServingFrontend(ann, ServingConfig(
            admission=AdmissionConfig(tile_lanes=16, deadline_s=0.05),
            writer=WriterConfig(8, 8), search=scfg), clock=lambda: t[0])
        reset_launches()
        rids = []
        for i, row in enumerate(q):
            rids.append(fe.submit(row))
            if i % 20 == 10:
                e = i // 20
                fe.submit_insert(pool[8 * e:8 * e + 8])
                fe.submit_delete(np.arange(100 + 12 * e, 112 + 12 * e))
            t[0] += 0.003
            fe.pump()
        fe.drain()
        if where == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["beam_score"] > 0 and LAUNCHES["rng_prune"] > 0
        summ = fe.telemetry.summary()
        out[where] = ([fe.result(r) for r in rids], [leaf.cpu() for _, leaf in flatten(ann.store)],
                      {k: summ[k] for k in ("tiles", "occupancy_hist", "staleness_max",
                                            "write_commits", "rows_written", "latency_ms")})
    for (a, ad), (b, bd) in zip(out["cpu"][0], out["cuda"][0]):
        assert np.array_equal(a, b) and np.array_equal(ad, bd)
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out["cpu"][2] == out["cuda"][2]


# ------------------------------------------------------------ sharded slice
@pytest.fixture(scope="module")
def sharded_on_the_card():
    """Two gloo ranks sharing the card (tests/_dist_workers.card_ranks) on a
    6,001-row corpus (odd, so the rows pad), with the single-device build
    and dense search they are held to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import _dist_workers as W
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x, q = clustered_vectors(VectorDatasetSpec.sift_like(6001, 96), gen, dev)
    cfg = rd.RNNDescentConfig(t1=2, t2=4)
    g = rd.build(x, cfg, torch.Generator(device=dev).manual_seed(1))
    ids, dists = S.search_tiled(x, g, q, S.default_entry_point(x),
                                S.SearchConfig(l=64, k=64, topk=10, visited="dense"), tile_b=64)
    torch.cuda.synchronize()
    return W.run(W.card_ranks, 2, x, q, g, ids, dists, cfg), x.shape[0], cfg


def test_comm_layer_stages_cuda_tensors_under_gloo(sharded_on_the_card):
    ranks, _, _ = sharded_on_the_card
    payload = {"ppermute": 24, "all_to_all": 32, "all_gather": 24, "pmin": 24, "psum": 24}
    for r in ranks:
        assert all(r["comm_equal"].values()), r["comm_equal"]
        assert r["comm_staged"] == payload, r["comm_staged"]


def test_sharded_build_on_the_card_equals_single_device(sharded_on_the_card):
    """Ring bytes: t1 t2 sweeps at 9 bytes a slot and t1 - 1 reverse passes
    at 22, over (n_pad / 2) x 256 slots, all staged through the host."""
    ranks, n, cfg = sharded_on_the_card
    half = -(-n // 2)
    closed = cfg.t1 * cfg.t2 * 9 * 256 * half + (cfg.t1 - 1) * 22 * 256 * half
    for r in ranks:
        assert r["build_equal"]
        assert r["sent"] == closed and r["staged"] == closed


@pytest.mark.parametrize("shard", ["queries", "corpus"])
def test_sharded_search_on_the_card_equals_single_device(sharded_on_the_card, shard):
    for r in sharded_on_the_card[0]:
        assert r[shard + "_equal"]


# ------------------------------------------------- GIST1M's width (d = 960)
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m", [50, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_rng_prune_at_gist_width(dev, dtype, metric, m, integer):
    """rng_prune (f32, bf16) and rng_prune_int8 on rows of a 960-wide corpus
    (7.5 times the d-chunks of d = 128 through the copy ring; int8's shared
    memory grows with d): bit for bit the plain version on integer-valued
    rows and codes, the agreement limits of the real-data tests otherwise."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rng_prune import ops as R
    from repro_torch.quant import int8_decode
    gen = torch.Generator(device=dev).manual_seed(21)
    n, d = 3000, 960
    if dtype == "int8" and integer:
        # small codes, dyadic scale, integer zero: every sum over 960 dims
        # stays exact in f32 (full-range codes would not)
        codes = torch.randint(-8, 9, (n, d), generator=gen, device=dev).to(torch.int8)
        scale = 2.0 ** -torch.randint(0, 2, (d,), generator=gen, device=dev).float()
        zero = torch.randint(-3, 4, (d,), generator=gen, device=dev).float()
        xv = int8_decode(codes, scale, zero)
    elif dtype == "int8":
        codes, scale, zero = _int8_space(gen, n, d, dev, integer)
        xv = int8_decode(codes, scale, zero)
    else:
        xv = (torch.randint(-8, 9, (n, d), generator=gen, device=dev).float() if integer
              else torch.randn(n, d, generator=gen, device=dev))
    ids, dists, flags = _graph(xv, m, gen)
    name = "rng_prune_int8" if dtype == "int8" else "rng_prune"
    before = LAUNCHES[name]
    if dtype == "int8":
        ker = R.rng_prune_int8(codes, scale, zero, ids, dists, flags, metric)
        ref = R.rng_prune_int8_plain(codes, scale, zero, ids, dists, flags, metric)
    else:
        xx = xv.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
        ker = R.rng_prune(xx, ids, dists, flags, metric)
        ref = R.rng_prune_plain(xx, ids, dists, flags, metric)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    if integer:
        for a, b in zip(ker, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    assert float((ker[0] == ref[0]).float().mean()) >= 0.999
    assert float((ker[1] == ref[1]).float().mean()) >= 0.999
    same = (ker[1] == ref[1]) & (ker[1] >= 0)
    xf = xv.float()
    assert float((ker[2] - ref[2])[same].abs().max()) <= 1e-5 * 2 * float((xf * xf).sum(1).max())


def test_pairwise_l2_at_gist_width(dev):
    """pairwise_l2 at d = 960: bit for bit on integer-valued rows, within
    1e-5 of |a|^2 + |b|^2 on real ones."""
    from repro_torch.kernels.pairwise_l2 import ops as P
    gen = torch.Generator(device=dev).manual_seed(22)
    ai = torch.randint(-8, 9, (300, 960), generator=gen, device=dev).float()
    bi = torch.randint(-8, 9, (5000, 960), generator=gen, device=dev).float()
    torch.testing.assert_close(P.pairwise_l2(ai, bi), P.pairwise_l2_ref(ai, bi), rtol=0, atol=0)
    a = torch.randn(300, 960, generator=gen, device=dev)
    b = torch.randn(5000, 960, generator=gen, device=dev)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    assert float(((P.pairwise_l2(a, b) - P.pairwise_l2_ref(a, b)).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("d", [128, 960])
def test_random_init_does_not_depend_on_the_gather_budget_on_the_card(dev, d, monkeypatch):
    """RandomGraph(S) at S = 20 drawn whole and in blocks of 4,096 pairs
    (the budget's derived block) is the same graph bit for bit, with the
    same distances."""
    from repro_torch.core import distances as D
    from repro_torch.core import graph as G
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(20_000, d, generator=gen, device=dev)
    graphs = []
    for budget in (1 << 40, 4 * d * 4 * 4096):
        monkeypatch.setattr(D, "GATHER_BUDGET", budget)
        graphs.append(G.random_init_graph(x, 20, 128, "l2",
                                          torch.Generator(device=dev).manual_seed(7)))
    for a, b in zip(*graphs):
        assert torch.equal(a, b)


def test_sharded_streaming_on_the_card_equals_single_device(dev, monkeypatch):
    """Two gloo ranks sharing the card: StreamingANN(mesh=) inserts 200
    points (the store grows) and deletes 150 rows; each store equals the
    single device's on the card leaf for leaf (seeding dense on both). The
    frontier sweeps and the repair prune through rng_prune on every rank,
    and the frontier exchange runs its ring."""
    import dataclasses

    import _dist_workers as W
    from repro_torch.core import rnn_descent as rd
    from repro_torch.streaming import StreamingANN
    from repro_torch.streaming import store as ST
    from repro_torch.streaming import updates as U
    gen = torch.Generator(device=dev).manual_seed(24)
    x = torch.randint(-8, 9, (1400, 24), generator=gen, device=dev).float()
    cfg = U.StreamingConfig(
        build=rd.RNNDescentConfig(s=8, r=16, t1=2, t2=3, capacity=24, chunk=128),
        seed_l=32, seed_k=12, seed_iters=64, batch_k=4, splice_k=6, delete_fanout=7)
    g0 = rd.build(x[:1200], cfg.build, torch.Generator(device=dev).manual_seed(1))
    store = ST.from_built(x[:1200], g0)
    orig = U.StreamingConfig.seed_search_cfg
    monkeypatch.setattr(U.StreamingConfig, "seed_search_cfg",
                        lambda self: dataclasses.replace(orig(self), visited="dense"))
    ann = StreamingANN(store=store, cfg=cfg)
    want = []
    ann.insert(x[1200:])
    want.append([t.clone() for _, t in W.store_leaves(ann.store)])
    ann.delete(torch.arange(100, 250))
    want.append([t.clone() for _, t in W.store_leaves(ann.store)])
    torch.cuda.synchronize()
    ranks = W.run(W.card_streaming, 2, store, cfg, x[1200:], torch.arange(100, 250), want)
    for r in ranks:
        assert all(r["insert"]) and all(r["delete"])
        assert r["launches"]["rng_prune"] == 2 + 1 and r["ring"] > 0


# ------------------------------------------------------- launch shapes, obs
def _spec_names():
    from repro_torch.analysis import kernel_check as KC
    return [s.name for s in KC.all_specs()]


def _card_specs(dev):
    from repro_torch.analysis import kernel_check as KC
    return KC.all_specs(torch.cuda.get_device_properties(dev).multi_processor_count)


@pytest.mark.parametrize("name", _spec_names())
def test_launch_shape_export_equals_the_spec(dev, name):
    """Each source's ``<entry>_launch_shape`` (the function its launcher
    takes the launch from) writes the Python spec's shape."""
    from repro_torch.analysis import kernel_check as KC
    spec = {s.name: s for s in _card_specs(dev)}[name]
    rc, got = KC.launch_export(spec)
    assert rc == 0 and got == spec.export()


def test_card_rules_clean_on_every_instance(dev):
    """Registers, spills, occupancy and static shared memory of every
    template instance, read from the card and the -Xptxas -v report."""
    from repro_torch.analysis import kernel_check as KC
    findings, rows = KC.check_card(_card_specs(dev), log=lambda *a, **k: None)
    assert findings == []
    assert len({(r["source"], r["instance"]) for r in rows}) == 38
    assert all(r["ptxas"] is None or "registers" in r["ptxas"] for r in rows)


def test_traced_medium_build_equals_untraced_on_the_card(dev):
    """A traced build and search on the card: bit for bit the untraced ones,
    one prune launch a sweep span, the spans' device time recorded."""
    from repro_torch import obs
    from repro_torch.core import rnn_descent as rd
    from repro_torch.core import search as S
    from repro_torch.obs import trace
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(20_000, 64, generator=gen, device=dev)
    q = torch.randn(500, 64, generator=gen, device=dev)
    cfg = rd.RNNDescentConfig(s=16, r=48, t1=3, t2=4, capacity=64)
    scfg = S.SearchConfig(l=32, k=32, max_iters=128, topk=10)

    def run():
        g = rd.build(x, cfg, torch.Generator(device=dev).manual_seed(1))
        return g, S.search_tiled(x, g, q, 0, scfg, tile_b=256, with_stats=True)

    g0, (i0, d0, st0) = run()
    obs.reset()
    try:
        with trace.enabled_scope():
            g1, (i1, d1, st1) = run()
        evs = trace.events()
    finally:
        obs.disable()
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert torch.equal(i0, i1) and torch.equal(d0, d1) and st0 == st1
    sweeps = [e for e in evs if e["name"] == "rnn_descent/sweep"]
    assert len(sweeps) == cfg.t1 * cfg.t2
    assert len([e for e in evs if e["name"] == "rnn_descent/reverse"]) == cfg.t1 - 1
    assert all(e["attrs"]["launches_rng_prune"] == 1 and e["attrs"]["device_ms"] > 0
               for e in sweeps)
    (tiled,) = [e for e in evs if e["name"] == "search/tiled"]
    assert tiled["attrs"]["work"] == st0["work"] and tiled["attrs"]["launches_beam_score"] > 0


def test_traced_sweeps_time_the_prune_and_the_merge_apart_on_the_card(dev, monkeypatch):
    """Each traced sweep on the card: its ``rng_prune/rows`` span holds the
    one prune launch, its ``graph/merge`` span the two ``bucket_merge``
    launches and their count of real candidates, both with device time
    inside the sweep's; the card is waited for once a sweep (the sweep's
    ``graphstats.sync`` and its end event), as before the child spans; the
    graph is the untraced one bit for bit."""
    from repro_torch import obs
    from repro_torch.core import rnn_descent as rd
    from repro_torch.obs import graphstats, trace
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(20_000, 64, generator=gen, device=dev)
    cfg = rd.RNNDescentConfig(s=16, r=48, t1=3, t2=4, capacity=64)
    g0 = rd.build(x, cfg, torch.Generator(device=dev).manual_seed(1))
    waits = {"sync": 0, "event": 0}
    inner_sync, inner_wait = graphstats.sync, torch.cuda.Event.synchronize

    def sync(t):
        waits["sync"] += 1
        inner_sync(t)

    def wait(ev):
        waits["event"] += 1
        inner_wait(ev)
    monkeypatch.setattr(graphstats, "sync", sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", wait)
    obs.reset()
    try:
        with trace.enabled_scope():
            g1 = rd.build(x, cfg, torch.Generator(device=dev).manual_seed(1))
        evs = trace.events()
    finally:
        obs.disable()
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    passes = cfg.t1 * cfg.t2 + cfg.t1 - 1
    assert waits == {"sync": passes, "event": passes}
    by = {k: [e["attrs"] for e in evs if e["name"] == k]
          for k in ("rnn_descent/sweep", "rng_prune/rows", "graph/merge")}
    assert all(len(v) == cfg.t1 * cfg.t2 for v in by.values())
    for sw, pr, mg in zip(*by.values()):
        assert pr["launches_rng_prune"] == 1 and pr["launches"] == 1
        assert mg["launches_bucket_scatter"] == mg["launches_bucket_row_merge"] == 1
        assert mg["launches"] == 2 and 0 < mg["cands_scattered"] <= 20_000 * 64
        assert pr["device_ms"] > 0 and mg["device_ms"] > 0
        assert pr["device_ms"] + mg["device_ms"] <= sw["device_ms"]
        assert pr["rows"] == mg["rows"] == 20_000 and pr["itemsize"] == 4
        assert 0 < pr["cands_valid"] <= pr["cands_valid_sq"]
        assert 0 < mg["rows_changed"] <= 20_000 and isinstance(mg["rows_changed"], int)


# ----------------------------------------------------------- the GNN family
def _gnn_graph(dev, n=400, deg=3, seed=0):
    """Distinct edges dst = src + U[1, n) mod n and every triplet (k == i
    included), on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randint(0, n, (n * deg,), generator=gen, device=dev)
    dst = (src + torch.randint(1, n, (n * deg,), generator=gen, device=dev)) % n
    key = torch.unique(src * n + dst)
    src, dst = key // n, key % n
    tk, tj = torch.nonzero(dst[:, None] == src[None, :], as_tuple=True)
    return {"node_feat": torch.randn(n, 8, generator=gen, device=dev),
            "pos": torch.randn(n, 3, generator=gen, device=dev) * 2.0,
            "edge_src": src.int(), "edge_dst": dst.int(),
            "edge_mask": torch.ones(src.shape[0], device=dev),
            "triplet_kj": tk.int(), "triplet_ji": tj.int(),
            "triplet_mask": torch.ones(tk.shape[0], device=dev),
            "labels": torch.randint(0, 5, (n,), generator=gen, device=dev, dtype=torch.int32)}


def test_dimenet_gather_equals_factorized_on_the_card(dev):
    """FULL width (n_spherical 7, n_radial 6, 6 blocks) in f32: the two
    triplet paths within the reference test's rtol 5e-4, atol 5e-5."""
    import dataclasses
    from repro_torch.configs import dimenet as D
    from repro_torch.models import dimenet as dm
    cfg = dataclasses.replace(D.FULL, d_feat=8, n_out=5, task="node_class",
                              compute_dtype=torch.float32)
    params = dm.init(torch.Generator(device=dev).manual_seed(1), cfg, dev)
    batch = _gnn_graph(dev)
    with torch.no_grad():
        g = dm.forward(params, batch, cfg)
        f = dm.forward(params, batch, dataclasses.replace(cfg, triplet_impl="factorized"))
    torch.testing.assert_close(f, g, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("impl", ["gather", "factorized"])
def test_dimenet_loss_and_gradients_on_the_card_equal_the_cpu(dev, impl):
    """The SMOKE widths in f32, one graph on both devices: loss within 1e-5
    relative, every gradient leaf within 1e-4 of its largest (the card's
    scatters add in another order)."""
    import dataclasses
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.configs import dimenet as D
    from repro_torch.models import dimenet as dm
    from repro_torch.train import value_and_grad
    cfg = dataclasses.replace(D.SMOKE, d_feat=8, n_out=5, task="node_class", triplet_impl=impl,
                              compute_dtype=torch.float32)
    batch = _gnn_graph(dev, seed=2)
    if impl == "factorized":
        e = batch["edge_src"].shape[0] // 4 * 4
        batch = {k: (v[:e].reshape(4, -1) if k.startswith("edge_") else v)
                 for k, v in batch.items() if not k.startswith("triplet")}
    params = dm.init(torch.Generator(device=dev).manual_seed(3), cfg, dev)
    loss_fn = lambda p, b: dm.loss_fn(p, b, cfg)
    lg, gg = value_and_grad(loss_fn, params, batch)
    lc, gc = value_and_grad(loss_fn, {k: v for k, v in _cpu_tree(params).items()},
                            _cpu_tree(batch))
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for (name, a), (_, b) in zip(flatten(gg), flatten(gc)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


def _cpu_tree(t):
    return {k: _cpu_tree(v) if isinstance(v, dict) else v.cpu() for k, v in t.items()}


def test_two_hop_sampler_on_the_card_equals_the_cpu(dev):
    """Given the same uniforms the map is deterministic: the card's subgraph
    is the CPU's bit for bit."""
    from repro_torch.data import sampler as SM
    g = SM.random_csr(torch.Generator(device=dev).manual_seed(4), 5000, 20, device=dev)
    u = SM.two_hop_uniforms(torch.Generator(device=dev).manual_seed(5), 64, 15, 10, device=dev)
    seeds = torch.arange(64, dtype=torch.int32, device=dev)
    got = SM.sample_two_hop(u, g, seeds, 15, 10)
    want = SM.sample_two_hop(tuple(x.cpu() for x in u), SM.CSRGraph(*(x.cpu() for x in g)),
                             seeds.cpu(), 15, 10)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# ------------------------------------------------------- mesh training slice
@pytest.fixture(scope="module")
def mesh_train_on_the_card(tmp_path_factory):
    """deepseek-smoke (f32, 2 x 128 tokens: the shard-mapped MoE) and
    deepfm-smoke (f32) trained on 2 x 2 gloo ranks sharing the card
    (tests/_mesh_workers.train_jobs) from the port's seeded state, with the
    one-device results on the card they are held to (deepseek's MoE as the
    mesh's per-shard loop, ``moe_tiles=(2, 2)``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    import _mesh_workers as W
    from repro_torch import configs
    from repro_torch.configs import base as cb
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tf
    from repro_torch.train import value_and_grad
    jobs, want = {}, {}
    for name, arch, shape, family in (("lm", "deepseek-moe-16b", "train_4k", "lm"),
                                      ("recsys", "deepfm", "train_batch", "recsys")):
        cfg = dataclasses.replace(configs.get(arch).make_config(shape, True),
                                  compute_dtype=torch.float32)
        one = steps.bind(arch, shape, reduced=True, device="cpu", _cfg=cfg)
        state = one.init_fn(torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(4)
        if family == "lm":
            t = torch.randint(0, cfg.vocab, (2, 129), generator=gen, dtype=torch.int32)
            batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]}]
            loss_fn = lambda p, b, cfg=cfg: tf.loss_fn(p, b, cfg, moe_tiles=(2, 2))
        else:
            batches = [cb.recsys_smoke_batch(gen, cfg, one.shape, "cpu")]
            loss_fn = lambda p, b, cfg=cfg: rs.loss_fn(p, b, cfg)
        jobs[name] = dict(family=family, arch=arch, shape=shape, cfg=cfg, mesh=(2, 2),
                          device="cuda", state=state, batches=batches)
        want[name] = value_and_grad(loss_fn, _to_card(state.params), _to_card(batches[0]))
    out = tmp_path_factory.mktemp("mesh_card")
    M.spawn(W.train_jobs, 4, (jobs, str(out)), backend="gloo")
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return got, want


def _to_card(tree):
    from repro_torch.checkpoint.checkpoint import flatten, unflatten
    return unflatten(tree, (t.cuda() for _, t in flatten(tree)))


@pytest.mark.parametrize("name", ["lm", "recsys"])
def test_mesh_train_on_the_card_equals_one_device(mesh_train_on_the_card, name):
    """Loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest (f32; the recsys tower is bf16 in both: within 2e-2)."""
    from repro_torch.checkpoint.checkpoint import flatten
    got, want = mesh_train_on_the_card
    loss, grads = want[name]
    for r in range(4):
        assert abs(got[r][name]["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for leaf, g in flatten(grads):
        g = g.float().cpu()
        tol = 2e-2 if "['mlp']" in leaf or "['dense_proj']" in leaf else 1e-4
        err = float((got[0][name]["grads"][leaf].float() - g).abs().max())
        assert err <= tol * float(g.abs().max()) + 1e-30, (leaf, err)


def test_mesh_recsys_launches_fm_interact_on_every_rank(mesh_train_on_the_card):
    got, _ = mesh_train_on_the_card
    for r in range(4):
        assert got[r]["recsys"]["launches"].get("fm_interact", 0) >= 1


# -------------------------------------------------------- mesh serving slice
@pytest.fixture(scope="module")
def mesh_serve_on_the_card(tmp_path_factory):
    """minitron-smoke (bf16, the config's own dtype) prefill of 4 x 32
    tokens into a cache of 48 and 3 decode steps, and retrieval over 4,096
    integer-valued candidates (top-100, n_valid 3,000), on 2 x 2 gloo ranks
    sharing the card (tests/_mesh_workers.serve_jobs), with the one-device
    results on the card they are held to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import _mesh_workers as W
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tf
    cfg = configs.get("minitron-4b").make_config("prefill_32k", True)
    params = tf.init(torch.Generator().manual_seed(5), cfg, device="cpu")
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab, (4, 32), generator=gen, dtype=torch.int32)
    toks = [torch.randint(0, cfg.vocab, (4,), generator=gen, dtype=torch.int32)
            for _ in range(3)]
    cand = torch.randint(-2, 3, (4096, 8), generator=gen).float()
    query = torch.randint(-2, 3, (8,), generator=gen).float()
    jobs = {"lm": dict(family="lm", arch="minitron-4b", cfg=cfg, mesh=(2, 2), device="cuda",
                       params=params, prompt=prompt, cache_len=48, decode=toks),
            "retrieval": dict(family="retrieval", mesh=(2, 2), device="cuda", query=query,
                              cand=cand, k=100, n_valid=3000)}
    out = tmp_path_factory.mktemp("mesh_serve_card")
    M.spawn(W.serve_jobs, 4, (jobs, str(out)), backend="gloo")
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    card = _to_card(params)
    with torch.no_grad():
        cache = tf.init_cache(cfg, 4, 48, device="cuda")
        logits, cache = tf.prefill(card, prompt.cuda(), cache, cfg)
        want = {"prefill": logits.float().cpu(), "decode": []}
        for t in toks:
            logits, cache = tf.decode_step(card, t.cuda(), cache, cfg)
            want["decode"].append(logits.float().cpu())
    want["retrieval"] = [rs.score_candidates(query.cuda(), cand.cuda(), k=100),
                         rs.score_candidates(query.cuda(), cand.cuda(), k=100, n_valid=3000)]
    return got, want


def test_mesh_serve_decode_on_the_card_equals_one_device(mesh_serve_on_the_card):
    """The prefill's and every decode step's logits on every rank within
    3e-2 of the one device's largest |logit| (bf16: the ranks' GEMMs and the
    split softmax round in other places)."""
    got, want = mesh_serve_on_the_card
    for r in range(4):
        res = got[r]["lm"]
        pairs = [(res["prefill"]["logits"], want["prefill"])] + \
            list(zip(res["decode"], want["decode"]))
        for g, w in pairs:
            err = float((g.float() - w).abs().max())
            assert err <= 3e-2 * float(w.abs().max()), (r, err)


def test_mesh_serve_retrieval_on_the_card_equals_one_device(mesh_serve_on_the_card):
    """Integer-valued candidates: exact scores, many ties, broken by the
    lower global id on the mesh as on one device."""
    got, want = mesh_serve_on_the_card
    (top, ids), (vtop, vids) = want["retrieval"]
    for r in range(4):
        res = got[r]["retrieval"]
        assert torch.equal(res["ids"], ids.cpu()) and torch.equal(res["top"], top.cpu())
        assert torch.equal(res["valid_ids"], vids.cpu())
        assert torch.equal(res["valid_top"], vtop.cpu())


def test_mesh_serve_dry_run_peak_of_minibatch_lg_on_the_card(dev):
    """The dry run's ``peak_bytes`` for DimeNet FULL minibatch_lg within 20 %
    of the card's high-water mark over one step of the same shapes (random
    edges over its node slots; the state and the batch counted, nothing
    else)."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import dryrun, steps
    pred = dryrun.run_cell("dimenet", "minibatch_lg")
    bound = steps.bind("dimenet", "minibatch_lg", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    state = bound.init_fn(gen)
    dims = cb.GNN_SHAPES[1].dims
    batch = {}
    for k, (shape, dtype) in bound.input_specs.items():
        if k in ("edge_src", "edge_dst", "labels"):
            hi = dims["n_out"] if k == "labels" else dims["n_nodes"]
            batch[k] = torch.randint(0, hi, shape, generator=gen, device="cuda", dtype=dtype)
        elif k in ("node_feat", "pos"):
            batch[k] = torch.randn(shape, generator=gen, device="cuda")
        else:                                       # the edge and label masks
            batch[k] = torch.ones(shape, dtype=dtype, device="cuda")
    batch["edge_dst"] = torch.where(batch["edge_dst"] == batch["edge_src"],
                                    (batch["edge_dst"] + 1) % dims["n_nodes"], batch["edge_dst"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    bound.step_fn(state, batch)
    torch.cuda.synchronize()
    own = pred["state_bytes"] + pred["batch_bytes"]
    card = torch.cuda.max_memory_allocated() - before + own
    assert abs(pred["peak_bytes"] - card) <= 0.2 * card, (pred["peak_bytes"], card)
