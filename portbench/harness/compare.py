"""The comparison that decides ``correct``: the program's outputs held to the
plain reference (``portbench/reference/``), each number beside its limit.

Limits come from the configuration file: ``guarantees.recall_at_10`` is
the recall the configuration states at its search config; ``limits`` hold
the largest relative distance error, set between the program's readings
and its lower-precision control's (PERF.md gives both). An exact
comparison (broken rows or answers) has the limit 0.
"""
from __future__ import annotations

import torch

from portbench.harness import data
from portbench.harness.runner import Check
from portbench.reference import graph as ref_graph
from portbench.reference import knn as ref_knn
from portbench.reference import results as ref_results

SAMPLE_STREAM = 99     # the generator stream that draws the rows checked one by one


def sample_rows(seed: int, n: int, m: int, device) -> torch.Tensor:
    """``min(m, n)`` distinct row indices drawn from the run's seed."""
    gen = data.generator(seed, SAMPLE_STREAM, device)
    return torch.randperm(n, generator=gen, device=device)[:min(m, n)]


def graph_checks(ctx, x, graph) -> list:
    """The graph's sampled rows against what they must satisfy."""
    rows = sample_rows(ctx.seed, x.shape[0], ctx.mix["check_rows"], x.device)
    r = ref_graph.check_rows(x, graph.neighbors, graph.dists, rows)
    return [Check("graph_bad", r["bad"], 0),
            Check("graph_dist_err", r["dist_rel_err"], ctx.cfg["limits"]["graph_dist_rel_err"])]


def answer_checks(ctx, x, queries, ids, dists, query_of=None) -> tuple[list, float]:
    """Every answer against its invariants, a sample of them against exact
    distances, and the recall@10 of all of them against the exact 10-NN of
    the queries asked (``query_of[j]``: the query row answer j answers)."""
    k = ids.shape[1]
    asked = torch.arange(ids.shape[0], device=x.device) if query_of is None else query_of
    true_ids, _ = ref_knn.exact_knn(x, queries, k)
    sample = sample_rows(ctx.seed + 1, ids.shape[0], ctx.mix["check_rows"], x.device)
    a = ref_results.check_answers(x, queries, ids, dists, sample, asked)
    recall = ref_results.recall(ids, true_ids[asked.long()])
    checks = [Check("answer_bad", a["bad"], 0),
              Check("answer_dist_err", a["dist_rel_err"],
                    ctx.cfg["limits"]["answer_dist_rel_err"]),
              Check("recall_at_10", recall, ctx.cfg["guarantees"]["recall_at_10"],
                    at_most=False)]
    return checks, recall
