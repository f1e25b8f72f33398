"""A sweep's merge of the prune's output (``core.rnn_descent.merge_pruned``)
and the wrapper of ``csrc/bucket_merge.cu`` on the CPU, where both run the
plain path: the kept rows sorted, then
``merge_candidate_edges(merge="bucketed")``.
The kernels themselves are held to that path on the card
(``tests/test_torch_cuda.py -k bucket_merge``)."""
import math

import pytest
import torch

from repro_torch.core import graph as G
from repro_torch.core import rnn_descent as rd
from repro_torch.kernels.bucket_merge import ops as BM

torch.set_num_threads(1)


def _sweep_input(n, m, metric, seed):
    """A graph after a few sweeps (rows of valid ids, each at most once) and
    its prune's output."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-8, 9, (n, 16), generator=gen).float()
    cfg = rd.RNNDescentConfig(s=min(12, m), r=m // 2, t1=1, t2=2, capacity=m, metric=metric)
    g = rd.random_init(x, cfg, gen)
    g = rd.update_neighbors(x, g, cfg)
    keep, red_w, red_d = rd.prune_rows(x, g.neighbors, g.dists, g.flags, cfg)
    return g, keep, red_w, red_d


def _old_merge(g, keep, red_w, red_d, n_buckets, cap):
    """The sweep's merge as ``update_neighbors`` wrote it before the
    ``bucket_merge`` wrapper."""
    inf = torch.tensor(float("inf"))
    pruned = G.sort_rows(G.Graph(torch.where(keep, g.neighbors, -1),
                                 torch.where(keep, g.dists, inf), torch.zeros_like(g.flags)))
    cand_dst = torch.where(red_w >= 0, g.neighbors, -1)
    return G.merge_candidate_edges(pruned, red_w.reshape(-1), cand_dst.reshape(-1),
                                   red_d.reshape(-1), cap=cap, merge="bucketed",
                                   n_buckets=n_buckets)


def _equal(a, b):
    return (torch.equal(a.neighbors, b.neighbors) and torch.equal(a.flags, b.flags)
            and torch.equal(a.dists.view(torch.int32), b.dists.view(torch.int32)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("m,n_buckets,cap", [(32, None, 32), (32, 16, 32), (32, 64, 20),
                                             (64, 1024, 64)])
def test_merge_on_the_cpu_is_the_sorted_rows_then_the_bucketed_merge(
        metric, m, n_buckets, cap):
    g, keep, red_w, red_d = _sweep_input(300, m, metric, seed=m + cap)
    want = _old_merge(g, keep, red_w, red_d, n_buckets, cap)
    b = n_buckets or G.default_buckets(cap)
    got, scattered = BM.bucket_merge(g.neighbors, g.dists, keep, red_w, red_d, b, cap)
    assert _equal(got, want) and int(scattered) > 0
    if cap == m:
        cfg = rd.RNNDescentConfig(r=m // 2, capacity=m, n_buckets=n_buckets)
        merged, count = rd.merge_pruned(g, keep, red_w, red_d, cfg)
        assert _equal(merged, want) and int(count) == int(scattered)


def test_merge_pruned_keeps_the_sort_oracle_on_request():
    g, keep, red_w, red_d = _sweep_input(200, 32, "l2", seed=3)
    inf = torch.tensor(float("inf"))
    pruned = G.sort_rows(G.Graph(torch.where(keep, g.neighbors, -1),
                                 torch.where(keep, g.dists, inf), torch.zeros_like(g.flags)))
    cand_dst = torch.where(red_w >= 0, g.neighbors, -1)
    want = G.merge_candidate_edges(pruned, red_w.reshape(-1), cand_dst.reshape(-1),
                                   red_d.reshape(-1), merge="sort")
    got, _ = rd.merge_pruned(g, keep, red_w, red_d, rd.RNNDescentConfig(r=16, capacity=32,
                                                                         merge="sort"))
    assert _equal(got, want)


def test_cands_scattered_counts_the_real_candidates():
    """Real: w in [0, n), v >= 0, w != v, red_d not NaN; counted slot by
    slot here, on inputs that hold each way to fail."""
    n, m = 6, 4
    ids = torch.tensor([[1, 2, -1, 3], [0, 2, 3, 4], [5, -1, -1, -1],
                        [0, 1, 2, 5], [3, -1, -1, -1], [0, 1, -1, -1]], dtype=torch.int32)
    dists = torch.where(ids >= 0, torch.arange(n * m).float().view(n, m), math.inf)
    keep = torch.zeros(n, m, dtype=torch.bool)
    red_w = torch.tensor([[4, -1, 2, 3], [3, 6, 3, 1], [0, -1, 5, -1],
                          [2, 2, 2, 2], [-1, -1, -1, -1], [5, 9, 0, 1]], dtype=torch.int32)
    red_d = torch.ones(n, m)
    red_d[1, 3] = float("nan")
    red_d[3, 0] = -0.0
    red_d[3, 1] = float("inf")
    red_d[5, 0] = -float("inf")
    real = 0
    for u in range(n):
        for j in range(m):
            w, v = int(red_w[u, j]), int(ids[u, j])
            real += 0 <= w < n and v >= 0 and w != v and not math.isnan(float(red_d[u, j]))
    assert real == 7
    g = G.Graph(ids, dists, torch.zeros(n, m, dtype=torch.uint8))
    out, scattered = rd.merge_pruned(g, keep, red_w, red_d,
                                     rd.RNNDescentConfig(s=2, r=2, capacity=m, n_buckets=8))
    assert scattered.dtype == torch.int64 and scattered.dim() == 0 and int(scattered) == real
    # row 3 offers w = 2 the candidates 0 (at -0.0), 1 (at +inf: not live) and 5;
    # 2 -> 2 is a self-loop
    assert out.neighbors[2].tolist() == [0, 5, -1, -1]
    assert torch.signbit(out.dists[2, 0]) and out.flags[2].tolist() == [1, 1, 0, 0]
    sort = rd.RNNDescentConfig(s=2, r=2, capacity=m, merge="sort")
    assert int(rd.merge_pruned(g, keep, red_w, red_d, sort)[1]) == real


def test_wrapper_rejects_what_the_kernel_does_not_take():
    n, m = 5, 4
    ids = torch.zeros(n, m, dtype=torch.int32)
    d = torch.zeros(n, m)
    keep = torch.zeros(n, m, dtype=torch.bool)
    w = torch.full((n, m), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids must be"):
        BM.bucket_merge(ids.long(), d, keep, w, d, 8)
    with pytest.raises(ValueError, match="dists must be"):
        BM.bucket_merge(ids, d.double(), keep, w, d, 8)
    with pytest.raises(ValueError, match="keep must be"):
        BM.bucket_merge(ids, d, keep.to(torch.uint8), w, d, 8)
    with pytest.raises(ValueError, match="red_w must be"):
        BM.bucket_merge(ids, d, keep, w[:, :3], d, 8)
    with pytest.raises(ValueError, match="red_d must be"):
        BM.bucket_merge(ids, d, keep, w, d.half(), 8)
    with pytest.raises(ValueError, match="one device"):
        BM.bucket_merge(ids, d, keep, w, d.to("meta"), 8)
    for b in (0, 100, 3):
        with pytest.raises(ValueError, match="power of two"):
            BM.bucket_merge(ids, d, keep, w, d, b)
    with pytest.raises(ValueError, match="cap"):
        BM.bucket_merge(ids, d, keep, w, d, 8, cap=m + 1)


def test_wrapper_on_the_cpu_takes_shapes_beyond_the_kernels():
    """More buckets than the kernels take, and rows wider than 256: on CPU
    tensors the wrapper runs the plain version."""
    for n, m, b in ((300, 32, 4096), (40, 260, 512)):
        g, keep, red_w, red_d = _sweep_input(n, m, "l2", seed=m)
        got, scattered = BM.bucket_merge(g.neighbors, g.dists, keep, red_w, red_d, b)
        assert not BM.kernel_takes(n, m, b, m)
        assert _equal(got, _old_merge(g, keep, red_w, red_d, b, m)) and int(scattered) > 0


def test_kernel_limits():
    assert BM.kernel_takes(1_000_000, 128, 256, 128)
    assert BM.kernel_takes(2**30 - 1, 256, 2048, 1)
    assert not BM.kernel_takes(2**30, 128, 256, 128)
    assert not BM.kernel_takes(10, 257, 512, 257)
    assert not BM.kernel_takes(10, 128, 4096, 128)
    assert not BM.kernel_takes(10, 128, 384, 128)
    assert not BM.kernel_takes(10, 64, 128, 65)
    assert not BM.kernel_takes(0, 64, 128, 64)
    spec = BM.kernel_spec("bucket_row_merge", 1_000_000, 128, 256)
    assert (spec.grid, spec.threads, spec.dyn_smem, spec.opt_in) == \
        ((250_000, 1, 1), 128, 4 * (256 + 512) * 8, False)
    assert BM.kernel_spec("bucket_row_merge", 10, 256, 2048).dyn_smem == 4 * 6144 * 8
    assert BM.kernel_spec("bucket_scatter", 1_000_000, 128).grid == (31_250, 1, 1)
