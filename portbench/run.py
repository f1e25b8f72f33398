"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cells; each
cell's configuration, traffic mix and per-layer metric readers are files
under ``portbench/`` found by name (``portbench/harness/registry.py``). The
last line of standard output is the result (``portbench/harness/runner.py``).
Without a CUDA card it exits 2 and prints no result.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PyTorch's and the CUDA driver's kernel caches stay in the checkout, at fixed
# paths (the program's own nvcc cache is <checkout>/build/kernels)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(ROOT, "build", "torch_kernels")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "cuda_cache")
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]   # in place of portbench/

from portbench.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], ROOT))
