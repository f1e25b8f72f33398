"""chip_smoke.py's GNN phase (9d), or parts of it, alone on the card.

    python3 scripts/gnn_phase.py [--parts all|cells,ogb,gather,smoke,entry,examples,
                                          profile,ogb_fresh]

Runs the chosen parts with chip_smoke.py's own functions, one JSON line
each: ``cells`` (DimeNet FULL at full_graph_sm, molecule and minibatch_lg,
with the sampler and the subgraph's invariants), ``ogb`` (ogb_products at
the largest edge cut that fits), ``gather`` (gather against factorized at
FULL width, f32), ``smoke`` (the SMOKE configs on the card against the
CPU), ``entry`` (``launch.train --arch dimenet --shape molecule
--reduced``), ``examples`` (the four examples/torch_*.py as subprocesses;
they build the kernels), ``profile`` (one ogb_products step at 2,097,152
edges in 16 chunks under torch.profiler after a warm step: the top aten
ops and kernels by device time), ``ogb_fresh`` (ogb_products with
10,092,544 edges in 64 chunks tried first: what a fresh process fits).
``all`` runs ``gnn_phase()`` itself.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def profile_ogb_step(cs, gen) -> None:
    """One DimeNet FULL ogb_products train step (2,097,152 edges, 16 chunks)
    under torch.profiler, after a warm step; prints the step's seconds and
    the top 16 entries by device time."""
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.launch import steps
    cfg = dataclasses.replace(configs.get("dimenet").make_config("ogb_products", False),
                              edge_chunks=16)
    batch = cs.ogb_batch(gen, 2_097_152, 16)
    b = steps.bind_with_cfg("dimenet", "ogb_products", cfg, device="cuda")
    state = b.init_fn(torch.Generator(device="cuda").manual_seed(cs.GNN_SEED + 1))
    state, _ = b.step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = b.step_fn(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    cs.emit({"phase": "gnn_profile", "edges": 2_097_152, "edge_chunks": 16,
             "profiled_step_s": sec})
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=16,
                                    max_name_column_width=60), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="all")
    args = ap.parse_args()
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("gnn_phase: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    if args.parts == "all":
        cs.emit({"gnn_phase": cs.gnn_phase()})
    gen = torch.Generator(device="cuda").manual_seed(cs.GNN_SEED)
    for part in args.parts.split(","):
        if part == "cells":
            cs.emit({"phase": "gnn", **cs.gnn_train_cell("full_graph_sm", cs.cora_batch(gen))})
            cs.emit({"phase": "gnn", **cs.gnn_train_cell("molecule", cs.molecule_batch(gen),
                                                           unit="graphs")})
            batch, ms, sub, g, seeds = cs.reddit_batch(gen)
            inv = cs.subgraph_invariants(sub, g, seeds)
            del sub, g
            cs.emit({"phase": "gnn", **cs.gnn_train_cell("minibatch_lg", batch),
                     "sampler_ms": ms, "invariants": inv})
            del batch
            cs._free()
        elif part == "ogb":
            cs.emit({"phase": "gnn", **cs.ogb_cell(gen)})
        elif part == "gather":
            cs.emit({"phase": "gnn_gather_vs_factorized", **cs.gather_vs_factorized()})
        elif part == "smoke":
            cs.emit({"phase": "gnn_smoke_card_vs_cpu", "configs": cs.gnn_smoke_card_vs_cpu()})
        elif part == "entry":
            cs.emit({"phase": "gnn_entry_point", **cs.gnn_entry_point()})
        elif part == "examples":
            cs.emit({"phase": "gnn_examples", "examples": cs.examples_on_the_card()})
        elif part == "profile":
            profile_ogb_step(cs, gen)
        elif part == "ogb_fresh":
            cs.OGB_CUTS = ((10_092_544, 64),) + cs.OGB_CUTS
            cs.emit({"phase": "gnn_ogb_fresh", **cs.ogb_cell(gen)})
        elif part != "all":
            raise SystemExit(f"unknown part {part!r}")
        cs.clock(part)
    return 0


if __name__ == "__main__":
    sys.exit(main())
