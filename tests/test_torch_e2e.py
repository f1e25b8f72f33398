"""The port's slice end to end on the CPU: RNN-Descent build, tiled beam
search and recall, held against the reference on the same corpus; plus the
package's import and device rules."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eval as RE
from repro.core import rnn_descent as RRD
from repro.core import search as RS
from repro_torch.core import eval as E
from repro_torch.core import rnn_descent as rd
from repro_torch.core import search as S

torch.set_num_threads(1)

# the configuration of tests/test_recall_regression.py (rnn-descent row)
BUILD = dict(s=8, r=24, t1=3, t2=4, capacity=32, chunk=256)
SEARCH = dict(l=32, k=24, max_iters=96, topk=10)
RECALL10_FLOOR = 0.95


def test_build_search_recall_matches_reference(small_dataset):
    """Different random initial graphs (torch vs JAX generators), so the
    graphs differ: they are held to the same quality. Tolerances: recall@10
    within 0.02 of the reference, average out-degree within 10 %,
    connectivity no worse than the reference's minus 0.01."""
    x, q, gt = small_dataset
    eps = np.asarray(jnp.broadcast_to(RS.default_entry_points(x, 4)[None], (q.shape[0], 4)))
    g_ref = RRD.build(x, RRD.RNNDescentConfig(**BUILD), jax.random.PRNGKey(1))
    ids_ref, _ = RS.search_tiled(x, g_ref, q, jnp.asarray(eps), RS.SearchConfig(**SEARCH),
                                 tile_b=64)
    r_ref = RE.recall_topk(ids_ref, gt)

    xt, qt, gtt = (torch.from_numpy(np.array(a)) for a in (x, q, gt))
    g = rd.build(xt, rd.RNNDescentConfig(**BUILD), torch.Generator().manual_seed(1))
    ids, dists = S.search_tiled(xt, g, qt, torch.from_numpy(eps.copy()),
                                S.SearchConfig(**SEARCH), tile_b=64)
    r = E.recall_topk(ids, gtt)
    assert r >= RECALL10_FLOOR, r
    assert abs(r - r_ref) <= 0.02, (r, r_ref)
    deg, deg_ref = E.degree_stats(g)["avg_out_degree"], RE.degree_stats(g_ref)["avg_out_degree"]
    assert abs(deg - deg_ref) <= 0.1 * deg_ref, (deg, deg_ref)
    entry = int(eps[0, 0])
    conn, conn_ref = E.connectivity_lower_bound(g, entry), RE.connectivity_lower_bound(g_ref, entry)
    assert conn >= conn_ref - 0.01, (conn, conn_ref)
    # results sorted, duplicate-free and valid
    assert (ids >= 0).all() and (torch.diff(dists, dim=1) >= 0).all()
    assert all(len(set(row.tolist())) == row.numel() for row in ids)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20   # every module of the package was imported


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    from repro_torch import convert
    from repro_torch.data.synthetic import VectorDatasetSpec, clustered_vectors
    spec = VectorDatasetSpec("unit", n=50, d=4, n_queries=5)
    z = np.zeros((50, 4), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        clustered_vectors(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.graph_from_numpy(np.zeros((50, 2), np.int32), np.zeros((50, 2), np.float32),
                                 np.zeros((50, 2), np.uint8))
    with pytest.raises(RuntimeError, match="cuda"):
        rd.build(z, rd.RNNDescentConfig(s=2, r=2, t1=1, t2=1, capacity=4))
    g = rd.build(torch.from_numpy(z), rd.RNNDescentConfig(s=2, r=2, t1=1, t2=1, capacity=4))
    assert g.neighbors.device.type == "cpu"   # a tensor runs on its own device
    with pytest.raises(RuntimeError, match="cuda"):
        S.search_tiled(z, g, z[:5], 0, S.SearchConfig(l=4, k=4))
