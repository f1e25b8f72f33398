"""Readings that the limits of ``correct`` are set from, several seeds in
one process (the benchmark's own runs never run this).

    python3 portbench/control.py --workload <name> --seeds 11 12 13 \
        [--precision bf16] [--seconds 5]

Without ``--precision`` each seed runs the cell as the benchmark does and
prints the numbers compared (the program's readings); with ``--precision
bf16`` it runs the control: the same cell through the program's own
lower-precision path (``gram_dtype="bf16"`` in the build's prune and the
search's beam kernel), which the comparison has to find not correct. One
JSON line a seed.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(ROOT, "build", "torch_kernels")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "cuda_cache")
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from portbench.harness import registry, runner  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", choices=("bf16",), default=None)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.Bench(ROOT)
    for seed in args.seeds:
        out = runner.run_cell(bench, args.workload, seed, args.seconds, False, "cuda",
                              time.perf_counter(), precision=args.precision)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision or "program", "correct": out["correct"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "checks": out["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
