"""chip_smoke.py's train phase (9c), or parts of it, alone on the card.

    python3 scripts/train_phase.py [--parts all|recsys,lm,moe,smoke,entry,lm_train]

Builds the kernels, warms them up and runs the chosen parts of the train
phase with chip_smoke.py's own functions, one JSON line each: ``recsys``
(the four recsys configs FULL at 65,536 rows and the FM backward),
``lm`` (minitron-4b FULL: prefill-then-decode, prefill_32k, decode_32k,
long_500k and train_4k at the largest depth that fits), ``moe``
(deepseek-moe-16b at full width), ``smoke`` (every SMOKE config on the
card against the CPU), ``entry`` (``launch.train`` and a forced restart),
``lm_train`` (minitron-4b train_4k alone: the largest depth that fits in a
fresh process, which can be deeper than inside the whole script, whose
earlier phases leave the allocator fragmented). ``all`` runs
``train_phase()`` itself. About 2 min of command time for ``all``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="all")
    args = ap.parse_args()
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import minitron_4b
    from repro_torch.kernels import _build
    _build.build_all()
    cs.warm_up()
    if args.parts == "all":
        cs.emit({"fm_interact_keys": cs.train_phase()})
    for part in args.parts.split(","):
        if part == "recsys":
            for arch_id in ("deepfm", "fm", "wide-deep", "xdeepfm"):
                cs.emit({"phase": "train_recsys", **cs.recsys_train_cell(arch_id)})
        elif part == "lm":
            cs.emit({"phase": "train_lm", **cs.minitron_phase()})
        elif part == "moe":
            cs.emit({"phase": "train_moe", **cs.deepseek_phase()})
        elif part == "smoke":
            cs.emit({"phase": "train_smoke_card_vs_cpu", "configs": cs.smoke_card_vs_cpu()})
        elif part == "entry":
            cs.emit({"phase": "train_entry_point", **cs.entry_point_phase()})
        elif part == "lm_train":
            full = minitron_4b.FULL
            depth, res, tried = cs._largest_fitting(cs.LM_DEPTHS, lambda L: cs.lm_train_steps(
                "minitron-4b", dataclasses.replace(full, n_layers=L), 2, 4096, 5))
            cs.emit({"phase": "train_lm_alone", "depths_tried": tried, **res})
        elif part != "all":
            raise SystemExit(f"unknown part {part!r}")
        cs.clock(part)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
