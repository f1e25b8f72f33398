"""What the benchmark imports. Top-level names are compared whole: the port
``repro_torch`` begins with the JAX package's name ``repro`` and is allowed
to the harness; the reference imports nothing of either."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
from portbench_tiny import ROOT

NEVER = {"jax", "jaxlib", "flax", "repro"}
BENCH = os.path.join(ROOT, "portbench")


def _sources(sub: str = ""):
    for dirpath, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_names(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_names_jax_or_the_jax_package():
    for path in _sources():
        assert not _top_names(path) & NEVER, path


def test_reference_sources_name_only_torch_and_the_standard_library():
    for path in _sources("reference"):
        assert _top_names(path) <= {"__future__", "torch", "math"}, path


def _loaded_after(code: str) -> set:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "src")])}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_everything_run_py_loads_leaves_jax_out():
    """run.py's modules, every driver, kind of data and metric reader,
    loaded in a fresh process, and the program's modules they call."""
    code = ("import glob, os, importlib\n"
            "from portbench.harness import registry, runner, compare, program, tracing\n"
            "b = registry.Bench(os.getcwd())\n"
            "for p in glob.glob('portbench/drivers/*.py'):\n"
            "    importlib.import_module('portbench.drivers.' + os.path.basename(p)[:-3])\n"
            "for p in glob.glob('portbench/layer_metrics/*.py'):\n"
            "    b.reader(os.path.basename(p)[:-3])\n"
            "for p in glob.glob('portbench/data/*.py'):\n"
            "    b.data_kind(os.path.basename(p)[:-3])\n"
            "import repro_torch.launch.steps, repro_torch.core.search, repro_torch.obs\n"
            "import repro_torch.core.rnn_descent\n")
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & NEVER, loaded & NEVER


def test_the_reference_loads_neither_package():
    loaded = _loaded_after("import portbench.reference.knn, portbench.reference.graph, "
                           "portbench.reference.results")
    assert not loaded & (NEVER | {"repro_torch"}), loaded & (NEVER | {"repro_torch"})


@pytest.mark.parametrize("name, bad", [("repro", True), ("repro_torch", False),
                                       ("jax", True), ("jaxlib", True), ("flax", True),
                                       ("jaxtyping", False)])
def test_guard_compares_whole_top_level_names(monkeypatch, name, bad):
    from portbench.harness import runner
    monkeypatch.setitem(sys.modules, name + ".sub", object())
    assert (name in runner.forbidden_modules()) is bad
