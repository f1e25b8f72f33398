"""NSG-style at the medium configuration over many random initial graphs.

    python3 scripts/nsg_seeds.py [--seeds 1-12] [--device cuda|cpu]

On chip_smoke.py's medium baseline corpus (``numpy_mixture``: n = 20k,
d = 128, 500 queries), builds NN-Descent (``NNDescentConfig()``) from each
seed's random initial graph, refines it with ``NSGStyleConfig()`` and
serves it (hashed ``search_tiled``, L = K = 64, top-10). Prints one JSON
line per seed: recall@10, the out-degree, the connectivity lower bound,
the rows filled to C = 132, and the repair's edges kept and dropped by full
rows (``chip_smoke.repair_contract``). It shows how far the repair's
outcome depends on the initial graph alone; ``--device cpu`` draws the
initial graphs with the CPU generator (about 70 s a seed).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="1-12", help="first-last")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    import chip_smoke as C
    from repro_torch.core import eval as E
    from repro_torch.core import nn_descent as nnd
    from repro_torch.core import nsg_style as nsg
    first, last = (int(s) for s in args.seeds.split("-"))
    if args.device == "cpu":       # search_graph waits for the card around its timing
        torch.cuda.synchronize = lambda *a, **k: None
    x, q = (torch.from_numpy(a).to(args.device)
            for a in C.numpy_mixture(C.MEDIUM_N, C.MEDIUM_Q, C.SEED))
    _, gt = E.ground_truth(x, q, k=10)
    for seed in range(first, last + 1):
        gen = torch.Generator(device=x.device).manual_seed(seed)
        kg = nnd.build(x, nnd.NNDescentConfig(), gen)
        with C.captured(nsg, "ensure_reachable") as repair:
            g = nsg.refine(x, kg, nsg.NSGStyleConfig())
        (_, pre, entry, _), _ = repair[0]
        res = C.search_graph(x, q, g, gt, C.MEDIUM_Q)
        print(json.dumps({"seed": seed, "recall_at_10": res["recall_at_10"],
                          "avg_out_degree": res["avg_out_degree"],
                          "connectivity": res["connectivity"],
                          "rows_full": int(((g.neighbors >= 0).sum(1) == g.capacity).sum()),
                          **C.repair_contract(x, pre, entry, g)}), flush=True)


if __name__ == "__main__":
    main()
