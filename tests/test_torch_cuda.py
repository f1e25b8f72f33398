"""The port's CUDA kernels against their plain versions, on the card.

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
