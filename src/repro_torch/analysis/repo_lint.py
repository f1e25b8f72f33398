"""AST-level repo lint for banned patterns in the port's library code
(``src/repro_torch``; the port of ``repro.analysis.repo_lint``).

Rules:

``bare-assert``
    ``assert`` statements in library runtime paths. Asserts vanish under
    ``python -O`` and die as context-free ``AssertionError``; library
    validation raises ``ValueError`` with a message naming the bad value
    and the expectation (the ``SearchConfig.__post_init__`` idiom). Tests
    are not scanned (pytest asserts are the point there).

``perf-timing``
    Direct ``time.perf_counter()`` / ``time.time()`` / ``time.monotonic()``
    (and ``_ns`` / ``process_time`` variants) calls in library runtime
    paths: ad-hoc wall-clock pairs fragment the timeline into private
    numbers no trace shows. Route through ``repro_torch.obs.trace.timed``
    (always measures; lands on the shared trace when obs is on) or accept
    a caller-supplied clock (the serving front end's idiom — referencing
    ``time.perf_counter`` as a default *value* is fine, calling it inline
    is not). ``repro_torch/obs/`` itself is exempt (it IS the sanctioned
    implementation).

``global-rng``
    The port's form of the reference's ``key-reuse``: a torch sampler
    called without ``generator=`` — ``torch.rand``, ``randn``,
    ``randint``, ``randperm``, ``multinomial``, ``normal``, ``bernoulli``
    and the in-place ``Tensor.normal_``, ``uniform_``, ``random_``,
    ``bernoulli_``, ``exponential_``. Without an explicit generator the
    draw comes from the process-wide stream, so a result depends on every
    draw made before it; the port threads a ``torch.Generator`` through
    every random step instead.

``reference-import``
    Any import of ``jax``, ``jaxlib`` or the JAX package (``repro`` and
    ``repro.*``): the port stands alone, and only its tests import both.
    This is the static form of the run-time check in
    ``tests/test_torch_e2e.py``, over every file.

The reference's ``hardcoded-interpret`` rule has no counterpart: a CUDA
kernel has no interpret mode, and a wrapper picks its plain version from
the device of its tensors, never from a flag.

Suppression: append ``# repo-lint: allow-<rule>`` on the offending line for
the rare legitimate case, with a comment giving the reason.
"""
from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.baseline import Finding

# stdlib wall-clock readers whose *call* in library code bypasses the obs
# tracer (referencing one as a default clock value is fine — no Call node).
_TIMING_FNS = {
    "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
    "time", "time_ns", "process_time", "process_time_ns",
}

# the sanctioned timing layer itself (and its CLI) may read the clock
_PERF_TIMING_EXEMPT = ("repro_torch/obs/",)

# torch samplers drawing from the process-wide stream unless handed a
# generator: module functions (torch.<fn>) and in-place tensor methods
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
                   "normal", "bernoulli", "rand_like", "randn_like",
                   "randint_like", "poisson"}
_TENSOR_SAMPLERS = {"normal_", "uniform_", "random_", "bernoulli_",
                    "exponential_", "cauchy_", "log_normal_", "geometric_"}

_REFERENCE_ROOTS = ("jax", "jaxlib", "repro")


def _allowed(src_lines: list[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(src_lines):
        return f"repo-lint: allow-{rule}" in src_lines[lineno - 1]
    return False


def _sampler(call: ast.Call) -> str | None:
    """'torch.randn' -> 'randn'; 'x.normal_' -> 'normal_'; else None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if (fn.attr in _TORCH_SAMPLERS and isinstance(fn.value, ast.Name)
            and fn.value.id == "torch"):
        return fn.attr
    if fn.attr in _TENSOR_SAMPLERS:
        return fn.attr
    return None


def _is_reference(module: str) -> bool:
    return module.split(".", 1)[0] in _REFERENCE_ROOTS


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, src_lines: list[str]):
        self.rel = rel
        self.lines = src_lines
        self.findings: list[Finding] = []

    def _where(self, node) -> str:
        return f"{self.rel}:{node.lineno}"

    def _flag(self, node, rule: str, detail: str) -> None:
        if not _allowed(self.lines, node.lineno, rule):
            self.findings.append(Finding("lint", rule, self._where(node), detail))

    def visit_Assert(self, node: ast.Assert):
        self._flag(node, "bare-assert",
                   "assert in a library runtime path: raise ValueError with a "
                   "message (vanishes under -O)")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            if _is_reference(alias.name):
                self._flag(node, "reference-import",
                           f"import {alias.name}: the port imports neither jax "
                           "nor the JAX package (copy what it needs)")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.level == 0 and node.module and _is_reference(node.module):
            self._flag(node, "reference-import",
                       f"from {node.module} import ...: the port imports "
                       "neither jax nor the JAX package (copy what it needs)")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr in _TIMING_FNS
                and isinstance(fn.value, ast.Name) and fn.value.id == "time"
                and not self.rel.startswith(_PERF_TIMING_EXEMPT)):
            self._flag(node, "perf-timing",
                       f"time.{fn.attr}() in a library runtime path: use "
                       "repro_torch.obs.trace.timed (shared timeline, exports "
                       "with the trace) or accept a caller-supplied clock")
        name = _sampler(node)
        if name is not None and not any(kw.arg == "generator"
                                         for kw in node.keywords):
            self._flag(node, "global-rng",
                       f"{name}() without generator=: the draw comes from the "
                       "process-wide stream; pass an explicit torch.Generator")
        self.generic_visit(node)


def lint_source(source: str, rel: str) -> list[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("lint", "syntax-error", f"{rel}:{e.lineno}", str(e))]
    v = _Visitor(rel, source.splitlines())
    v.visit(tree)
    return v.findings


def run(root: str | pathlib.Path | None = None, log=print) -> list[Finding]:
    """Lint every ``.py`` under ``root`` (default: the ``src/repro_torch``
    library tree)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[1]   # src/repro_torch
    root = pathlib.Path(root)
    findings: list[Finding] = []
    n_files = 0
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent).as_posix()
        findings.extend(lint_source(path.read_text(), rel))
        n_files += 1
    log(f"repo-lint: {n_files} files under {root}: "
        f"{len(findings) or 'no'} finding{'s' if len(findings) != 1 else ''}")
    return findings
