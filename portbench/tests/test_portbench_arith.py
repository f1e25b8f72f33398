"""The metric arithmetic on fixed inputs: rates over a whole window,
percentiles over every call, spreads, the idle share and gaps of a
synthetic device trace, and a roofline from a fixed count."""
from __future__ import annotations

import pytest
from portbench_tiny import ROOT  # noqa: F401  (puts the repository on sys.path)

from portbench.harness import profile, roofline, stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(40 * 4096, 8.0) == 20480.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentiles_over_every_call():
    calls = list(range(1, 201))            # 200 calls of 1..200 ms
    assert stats.percentile(calls, 95) == pytest.approx(190.05)
    assert stats.percentile(calls, 90) == pytest.approx(180.1)
    assert stats.percentile(calls, 50) == pytest.approx(100.5)
    assert stats.percentile([7.0], 95) == 7.0


def _trace():
    # window 0..1000 us; device ops overlap at 100-300 and 250-400; a gap
    # 400-600 while the host runs "sync" (nested in "loop"), 600-900 busy
    dev = [(100, 300, "k_a"), (250, 400, "k_b"), (600, 900, "k_a"), (950, 1200, "Memcpy DtoH"),
           (-50, 20, "k_c")]
    host = [(0, 1000, "loop"), (420, 580, "sync"), (900, 1000, "tail")]
    return profile.reduce(dev, host, (0, 1000))


def test_busy_is_the_union_clipped_to_the_window():
    s = _trace()
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((20 + 300 + 300 + 50) * 1e-6)
    assert s["device_n"] == {"k_c": 1, "k_a": 2, "k_b": 1, "Memcpy DtoH": 1}
    assert s["kernels"] == 4                   # the copy is not a kernel
    assert s["device_s"]["k_a"] == pytest.approx(500e-6)


def test_idle_gaps_charged_to_the_innermost_host_op():
    gaps = dict((n, v) for n, v in _trace()["idle_gaps"])
    assert gaps["sync"] == pytest.approx(200e-6)      # 400-600, midpoint in "sync"
    assert gaps["loop"] == pytest.approx(80e-6)       # 20-100
    assert gaps["tail"] == pytest.approx(50e-6)       # 900-950
    assert sum(gaps.values()) == pytest.approx(330e-6)


def test_idle_share_reader():
    from portbench.harness.registry import Bench
    read = Bench(ROOT).reader("device.idle.search")

    class T:
        summary = _trace()
    assert read(T) == pytest.approx(100 * (1 - 670 / 1000))
    T.summary = None
    assert read(T) is None


def test_beam_score_roofline_from_a_fixed_count():
    # 1,000 expansions over 4 launches of 4,096 lanes, 17 valid candidates an
    # expansion, k = 64, d = 128, f32 rows
    flops, nbytes = roofline.beam_score_work(1000, 4 * 4096, 17, 64, 128, 4)
    assert flops == 1000 * 17 * 4 * 128
    assert nbytes == 1000 * 17 * 512 + 1000 * (256 + 512) + 4 * 4096 * (4 + 768)
    least = roofline.least_seconds(flops, nbytes)
    assert least == pytest.approx(nbytes / 3.35e12)
    from portbench.harness.registry import Bench
    read = Bench(ROOT).reader("beam_score_roofline")

    class T:
        summary = {"device_s": {"void beam_score_kernel<float, 32, 1>(int)": 2 * least},
                   "device_n": {"void beam_score_kernel<float, 32, 1>(int)": 4}}
        stats = {"profiled_work": 1000, "tile": 4096, "valid_per_expansion": 17, "k": 64,
                 "d": 128, "itemsize": 4}
    assert read(T) == pytest.approx(50.0)


def test_sweep_readers_from_spans():
    from portbench.harness.registry import Bench
    b = Bench(ROOT)

    def sweep(ms, new, live):
        return {"name": "rnn_descent/sweep", "attrs": {"device_ms": ms, "edges_new": new,
                                                      "edges_live": live}}

    class T:
        spans = [sweep(400.0, 5_000_000, 18_000_000), sweep(390.0, 100_000, 15_000_000),
                 sweep(380.0, 149_999, 15_000_000),
                 {"name": "rnn_descent/reverse", "attrs": {"device_ms": 1000.0}},
                 sweep(410.0, 10, 15_000_000)]
        stats = {"builds": 2}
    assert b.reader("build.sweep_s")(T) == pytest.approx((400 + 390 + 380 + 410) / 1e3 / 2)
    assert b.reader("build.quiet_sweep_s")(T) == pytest.approx((390 + 380 + 410) / 1e3 / 2)
    T.spans = []
    assert b.reader("build.sweep_s")(T) is None


def test_the_mixture_is_the_seeds_around_the_configurations_centres():
    import torch

    from portbench.harness import data, registry
    from portbench.harness.runner import Ctx
    spec = {"kind": "gaussian_mixture", "clusters": 4, "cluster_std": 0.01, "centres_seed": 0}
    cfg = {"n": 300, "d": 8, "queries": 40, "data": spec}
    kind = registry.Bench(ROOT).data_kind("gaussian_mixture")

    def made(seed, queries=None):
        return data.make(Ctx(cfg, {}, seed, torch.device("cpu"), False, kind), queries)
    xa, qa = made(2 ** 31 + 5)
    assert xa.shape == (300, 8) and qa.shape == (40, 8) and xa.dtype == torch.float32
    assert torch.equal(xa, made(2 ** 31 + 5)[0]) and torch.equal(qa, made(2 ** 31 + 5)[1])
    xb, qb = made(11, 64)
    assert qb.shape == (64, 8) and not torch.equal(xa, xb)
    # both seeds' rows lie around the same four centres, another centres_seed's not
    assert torch.cdist(torch.cat([xb, qb]), xa).min(dim=1).values.max() < 0.2
    spec["centres_seed"] = 1
    assert torch.cdist(made(11)[0], xa).min(dim=1).values.max() > 0.5
