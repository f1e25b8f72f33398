"""chip_smoke.py's mesh phases (9e training, 9f serving), or parts of
them, alone on the card.

    python3 scripts/mesh_phase.py [--parts all|grid,restart,serve]

Builds the kernels, then runs the chosen parts with chip_smoke.py's own
functions, one JSON line each: ``grid`` (deepseek-moe-16b at full width,
2 layers, DeepFM FULL train_batch and DimeNet FULL width minibatch_lg, one
after the other on the same 2 x 2 gloo ranks sharing the card, each held
against one device; fm_interact on every rank), ``restart``
(launch.train --ranks 4 --mesh 2x2, resumed from a checkpoint), ``serve``
(``mesh_serve_phase()``: the LM prefill and decode cells, DeepFM serve_bulk
and retrieval_cand on 2 x 2 gloo ranks, each held against one device).
``all`` runs ``mesh_train_phase()`` itself. The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/mesh_phase.py")
    ap.add_argument("--parts", default="all")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    print(cs.nvidia_smi(), flush=True)
    built = _build.build_all()
    cs.emit({"phase": "build", "seconds": built["seconds"]})
    cs.warm_up()
    parts = args.parts.split(",")
    if parts == ["all"]:
        cs.emit({"phase": "mesh_train_keys", **cs.mesh_train_phase()})
        return 0
    for part in parts:
        if part == "grid":
            for cell, res in zip(("lm", "recsys", "gnn"), cs._mesh_grid_cells()):
                cs.emit({"phase": "mesh_train", "cell": cell, **res})
        elif part == "serve":
            cs.emit({"phase": "mesh_serve_keys", **cs.mesh_serve_phase()})
        else:
            cs.emit({"phase": "mesh_train", "cell": part, **cs._mesh_restart()})
        cs.clock(f"mesh_{part}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
