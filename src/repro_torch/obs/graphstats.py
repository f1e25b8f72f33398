"""Host-side per-sweep graph readouts for build spans (the port of
``repro.obs.graphstats``).

Only called from inside an ``if sp:`` (tracing-enabled) branch: every
function here *reads* the already-computed graph with small device
reductions and converts to host ints; it never feeds anything back into
the build, so the traced build's adjacency stays bit for bit the untraced
one (the obs parity contract). The readouts are the counters the paper's
tuning discussion needs: how many candidate edges each sweep accepted
(``flags == NEW`` after the merge), how many adjacency slots are live, and
the slot occupancy the capacity cap is running at. The prune's and the
merge's counts (:func:`prune_counts`, :func:`merge_counts`) stay on the
device until the sweep's one wait (``cudahooks.span_costs``). All of them
come from one pair of per-row counts (:func:`row_counts`) of each graph
state, taken once: the merge counts its output, and the sweep's readouts
and the next prune read those counts again.
"""
from __future__ import annotations

import threading
import weakref

import torch

from repro_torch.core import graph as G
from repro_torch.obs import metrics as M

OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


_last = threading.local()      # the graph state counted last, per thread


def row_counts(g: G.Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``g``: its live slots (ids >= 0) and its live slots
    flagged NEW, int32 on the device. The counts of the last state counted
    are kept while its tensors live unchanged (same objects, same versions),
    so a merged graph counted for its merge span is not reduced again for
    its sweep's readouts or for the next prune's (inference tensors carry
    no version, and are counted every time)."""
    keep = not (g.neighbors.is_inference() or g.flags.is_inference())
    key = (g.neighbors._version, g.flags._version) if keep else None
    hit = getattr(_last, "counts", None)
    if keep and hit is not None and hit[0]() is g.neighbors and hit[1]() is g.flags \
            and hit[2] == key:
        return hit[3]
    live = g.neighbors >= 0
    counts = (live.sum(1, dtype=torch.int32),
              (live & (g.flags == G.NEW)).sum(1, dtype=torch.int32))
    if keep:
        _last.counts = (weakref.ref(g.neighbors), weakref.ref(g.flags), key, counts)
    return counts


def sweep_stats(g: G.Graph) -> dict:
    """{edges_live, edges_new, occupancy} of one graph state (host values;
    blocks on two small reductions)."""
    live_r, new_r = row_counts(g)
    live = int(live_r.sum())
    new = int(new_r.sum())
    slots = int(g.neighbors.shape[0] * g.neighbors.shape[1])
    return {
        "edges_live": live,
        "edges_new": new,
        "occupancy": live / slots if slots else 0.0,
    }


def record_sweep(sp, g: G.Graph, *, algo: str, phase: str,
                 prev_live: int | None = None, **extra) -> int:
    """Attach sweep stats to span ``sp`` and fold them into the metrics
    registry. ``phase`` is "sweep" for candidate-update sweeps (edges_new
    counts accepted candidates) or "reverse" for reverse-edge passes
    (edges_new counts accepted reverse offers). Returns ``edges_live`` so
    the caller can thread it into the next sweep's ``prev_live`` (the
    pruned-edge estimate)."""
    st = sweep_stats(g)
    sp.set(**st, **extra)
    reg = M.REGISTRY
    reg.counter(f"build_{phase}s_total", help=f"{phase} passes recorded",
                algo=algo).inc()
    kind = "reverse_offers" if phase == "reverse" else "candidates"
    reg.counter(f"build_{kind}_accepted_total",
                help=f"edges flagged NEW after each {phase} merge",
                algo=algo).inc(st["edges_new"])
    reg.gauge("build_edges_live", help="live adjacency slots after the "
              "latest recorded pass", algo=algo).set(st["edges_live"])
    reg.histogram("build_slot_occupancy", buckets=OCCUPANCY_BUCKETS,
                  help="live slots / capacity per recorded pass",
                  algo=algo).observe(st["occupancy"])
    if prev_live is not None:
        # slots that were live and are no longer: the sweep's pruned-edge
        # count net of re-insertions (a host-side delta that never touches
        # the build)
        pruned = max(0, prev_live + st["edges_new"] - st["edges_live"])
        sp.set(edges_pruned=pruned)
        reg.counter("build_edges_pruned_total",
                    help="net live-slot loss per sweep (pruned minus "
                         "re-inserted)", algo=algo).inc(pruned)
    return st["edges_live"]


def prune_counts(g: G.Graph) -> dict:
    """{cands_valid, cands_valid_sq}: over the rows of the graph ``g`` that
    goes into a prune, the sum of each row's valid candidates v (ids >= 0)
    and of v squared, the prune's work (v(v + 1) d operations and v d
    gathered elements a row). Device scalars, for ``span_costs``' defer."""
    v = row_counts(g)[0].long()
    return {"cands_valid": v.sum(), "cands_valid_sq": (v * v).sum()}


def merge_counts(g: G.Graph) -> dict:
    """{rows_changed}: the rows of a merge's output ``g`` that hold an edge
    flagged NEW. A device scalar, for ``span_costs``' defer."""
    return {"rows_changed": (row_counts(g)[1] > 0).sum()}


def sync(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device (a no-op on the CPU), so a
    span's wall time covers its kernels: the port's counterpart of the
    reference's ``jax.block_until_ready`` inside a traced span."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
