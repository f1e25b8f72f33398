"""Port parity: the two-hop neighbour sampler (``repro_torch.data.sampler``)
and ``data.synthetic.random_graph_batch`` against the reference (JAX, CPU).

The port splits the sampler into a draw and a map; given the uniforms the
reference draws (``k1, k2 = split(key)``, ``uniform(k1, (S, f1))``,
``uniform(k2, (S f1, f2))``), every field of the subgraph must be the
reference's bit for bit. Graphs: the reference's ``random_csr`` and a
numpy CSR with rows of degree 0 (the masked slots).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sampler as JS
from repro_torch.data import sampler as S
from repro_torch.data.synthetic import random_graph_batch

torch.set_num_threads(1)


def _csr_np(seed, n=300, max_deg=12):
    """A CSR graph with degrees in [0, max_deg], about a fifth of them 0."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, n) * (rng.random(n) > 0.2)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col


def _graphs(seed):
    ref = JS.random_csr(jax.random.PRNGKey(seed), n_nodes=500, avg_degree=8)
    return [tuple(np.asarray(a) for a in ref), _csr_np(seed)]


_sample_two_hop = jax.jit(JS.sample_two_hop, static_argnums=(3, 4))


def _port(g):
    return S.CSRGraph(*(torch.from_numpy(np.asarray(a)) for a in g))


def _ref(g):
    return JS.CSRGraph(*(jnp.asarray(a) for a in g))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fanout", [(5, 3), (15, 10)])
def test_sample_two_hop_matches_reference_bit_for_bit(seed, fanout):
    f1, f2 = fanout
    for g in _graphs(seed):
        n = g[0].shape[0] - 1
        seeds = np.random.default_rng(seed).choice(n, 16, replace=False).astype(np.int32)
        key = jax.random.PRNGKey(100 + seed)
        want = _sample_two_hop(key, _ref(g), jnp.asarray(seeds), f1, f2)
        k1, k2 = jax.random.split(key)
        u = (torch.from_numpy(np.array(jax.random.uniform(k1, (16, f1)))),
             torch.from_numpy(np.array(jax.random.uniform(k2, (16 * f1, f2)))))
        got = S.sample_two_hop(u, _port(g), torch.from_numpy(seeds), f1, f2)
        for name, a, b in zip(S.SampledSubgraph._fields, got, want):
            b = np.asarray(b)
            assert a.dtype == torch.from_numpy(b).dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_neighbors_from_uniform_matches_uniform_neighbors():
    """Frontier entries below 0 and rows of degree 0 give -1; the slot is
    floor(u * deg), clamped to the last entry of col_idx."""
    g = _csr_np(3)
    n = g[0].shape[0] - 1
    frontier = np.concatenate([np.arange(n), [-1, -1, n - 1]]).astype(np.int32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JS.uniform_neighbors(key, _ref(g), jnp.asarray(frontier), 6))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (frontier.shape[0], 6))))
    got = S.neighbors_from_uniform(u, _port(g), torch.from_numpy(frontier))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[-3:-1] == -1).all()
    assert (got[:n][torch.from_numpy(np.diff(g[0]) == 0)] == -1).all()


def test_neighbor_sampler_shapes_and_validity():
    """The reference's ``test_neighbor_sampler_shapes_and_validity`` on the
    port's own draws, plus: every sampled neighbour lies in its parent's
    CSR row."""
    gen = torch.Generator().manual_seed(0)
    g = S.random_csr(gen, n_nodes=500, avg_degree=8, device="cpu")
    assert g.row_ptr.dtype == g.col_idx.dtype == torch.int32
    assert g.row_ptr.shape == (501,) and int(g.row_ptr[-1]) == g.col_idx.shape[0] == 4000
    seeds = torch.arange(16, dtype=torch.int32)
    s = 16
    u = S.two_hop_uniforms(gen, s, 5, 3, device="cpu")
    assert u[0].shape == (16, 5) and u[1].shape == (80, 3)
    sub = S.sample_two_hop(u, g, seeds, fanout1=5, fanout2=3)
    assert sub.nodes.shape == (s * (1 + 5 + 15),)
    assert sub.edge_src.shape == (s * 5 + s * 15,)
    nodes = sub.nodes.numpy()
    assert nodes[:s].tolist() == list(range(16))
    valid = nodes[nodes >= 0]
    assert valid.max() < 500
    esrc, edst, emask = sub.edge_src.numpy(), sub.edge_dst.numpy(), sub.edge_mask.numpy()
    # every masked-in edge points at a valid local node slot
    assert (nodes[esrc[emask > 0]] >= 0).all()
    rp, col = g.row_ptr.numpy(), g.col_idx.numpy()
    for child, parent in zip(nodes[esrc[emask > 0]], nodes[edst[emask > 0]]):
        assert child in col[rp[parent]:rp[parent + 1]]


def test_uniform_neighbors_draws_on_the_graph_device():
    g = S.random_csr(torch.Generator().manual_seed(1), 50, 4, device="cpu")
    a = S.uniform_neighbors(torch.Generator().manual_seed(2), g, torch.arange(10), 3)
    u = torch.rand((10, 3), generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, S.neighbors_from_uniform(u, g, torch.arange(10)))
    with pytest.raises(ValueError, match="uniforms"):
        S.sample_two_hop((u, u), g, torch.arange(10), 3, 2)


def test_random_graph_batch():
    gen = torch.Generator().manual_seed(0)
    b = random_graph_batch(gen, 40, 100, 7, positions=True, device="cpu")
    assert b["edge_src"].dtype == b["edge_dst"].dtype == torch.int32
    assert b["edge_src"].shape == b["edge_dst"].shape == (100,)
    assert int(b["edge_src"].max()) < 40 and int(b["edge_dst"].min()) >= 0
    assert b["node_feat"].shape == (40, 7) and b["pos"].shape == (40, 3)
    assert "pos" not in random_graph_batch(gen, 40, 100, 7, device="cpu")
    again = random_graph_batch(torch.Generator().manual_seed(0), 40, 100, 7, positions=True,
                               device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
