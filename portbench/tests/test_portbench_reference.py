"""The plain reference at a small size: exact k-NN against a NumPy brute
force, and the graph and answer checks against rows broken on purpose."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from portbench_tiny import ROOT  # noqa: F401

from portbench.reference import graph as ref_graph
from portbench.reference import knn as ref_knn
from portbench.reference import results as ref_results


@pytest.fixture(scope="module")
def corpus():
    gen = torch.Generator().manual_seed(5)
    return torch.randn(700, 24, generator=gen), torch.randn(50, 24, generator=gen)


def test_exact_knn_equals_numpy(corpus):
    x, q = corpus
    ids, d = ref_knn.exact_knn(x, q, 10, q_block=16, x_block=128)
    xn, qn = x.double().numpy(), q.double().numpy()
    full = ((qn[:, None, :] - xn[None, :, :]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert np.array_equal(ids.numpy(), want)
    assert np.allclose(d.numpy(), np.take_along_axis(full, want, 1), rtol=1e-12)


def _graph(x, m=12):
    """Each row: its m exact nearest other rows, ascending, two empty slots."""
    ids, d = ref_knn.exact_knn(x, x, m + 1)
    nb = torch.full((x.shape[0], m + 2), -1, dtype=torch.int32)
    dist = torch.full((x.shape[0], m + 2), float("inf"))
    nb[:, :m] = ids[:, 1:].int()
    dist[:, :m] = d[:, 1:].float()
    return nb, dist


def test_graph_check_accepts_a_sound_graph(corpus):
    x, _ = corpus
    nb, dist = _graph(x)
    r = ref_graph.check_rows(x, nb, dist, torch.arange(x.shape[0]))
    assert r["bad"] == 0 and r["live"] == 700 * 12 and r["dist_rel_err"] < 1e-6


@pytest.mark.parametrize("fault", ["id_out_of_range", "self", "repeat", "after_empty",
                                   "descent", "empty_dist", "other_id", "dist"])
def test_graph_check_rejects_a_corrupted_row(corpus, fault):
    x, _ = corpus
    nb, dist = _graph(x)
    r0 = 37
    if fault == "id_out_of_range":
        nb[r0, 3] = 700
    elif fault == "self":
        nb[r0, 3] = r0
    elif fault == "repeat":
        nb[r0, 4] = nb[r0, 3]
    elif fault == "after_empty":
        nb[r0, 13] = 5
        dist[r0, 13] = dist[r0, 11] + 1
    elif fault == "descent":
        dist[r0, 4], dist[r0, 5] = dist[r0, 5].item(), dist[r0, 4].item()
    elif fault == "empty_dist":
        dist[r0, 12] = 1.0
    elif fault == "other_id":          # an answer altered where it is produced
        nb[r0, 0] = int(nb[r0, 11]) + 1 if int(nb[r0, 11]) + 1 != r0 else 0
    elif fault == "dist":
        dist[r0, 2] *= 1.001
    r = ref_graph.check_rows(x, nb, dist, torch.arange(x.shape[0]))
    if fault in ("other_id", "dist"):
        assert r["dist_rel_err"] > 1e-4
    else:
        assert r["bad"] >= 1


def test_answer_check_and_recall(corpus):
    x, q = corpus
    ids, d = ref_knn.exact_knn(x, q, 10)
    ids32, d32 = ids.int(), d.float()
    ok = ref_results.check_answers(x, q, ids32, d32, torch.arange(50))
    assert ok["bad"] == 0 and ok["dist_rel_err"] < 1e-6
    assert ref_results.recall(ids32, ids) == 1.0
    # answers asked through a map: answer j answers query 49 - j
    rev = torch.arange(49, -1, -1)
    flipped = ref_results.check_answers(x, q, ids32[rev], d32[rev], torch.arange(50), rev)
    assert flipped["dist_rel_err"] < 1e-6
    broken = ids32.clone()
    broken[3, 2] = broken[3, 1]
    broken[4, 0] = -1
    bad = ref_results.check_answers(x, q, broken, d32, torch.arange(50))
    assert bad["bad"] == 2
    other = ids32.clone()
    other[7, 0] = other[8, 0]
    assert ref_results.check_answers(x, q, other, d32, torch.arange(50))["dist_rel_err"] > 1e-3
    half = ids32.clone()
    half[25:] = ids32[:25]
    assert ref_results.recall(half, ids) < 0.6
