"""The port's static-analysis layer (``repro_torch.analysis``) on the CPU:
each lint rule on a seeded snippet and silenced by its pragma, the kernel
launch-shape rules on seeded bad specs and on the shipped ones, the
baseline and CLI gate (the reference's ``TestBaselineAndCLI``, one for
one), the rebuild guard, and the dispatch audit on seeded ops and on the
registered entry points. The collectives pass runs inside the gloo worker
of ``tests/test_torch_distributed.py``; the card-only kernel rules in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis import baseline as B
from repro_torch.analysis import dispatch_audit as DA
from repro_torch.analysis import kernel_check as KC
from repro_torch.analysis import recompile_guard as RG
from repro_torch.analysis import repo_lint as RL
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.kernels import spec as K

torch.set_num_threads(1)


def _silent(*a, **k):
    pass


def _rules(findings) -> list[str]:
    return [f.rule for f in findings]


# --------------------------------------------------------------------- lint
SNIPPETS = {
    "bare-assert": "def f(x):\n    assert x > 0{pragma}\n",
    "perf-timing": "import time\n\ndef f():\n    return time.perf_counter(){pragma}\n",
    "global-rng": "import torch\n\ndef f():\n    return torch.randn(3){pragma}\n",
    "reference-import": "import jax.numpy as jnp{pragma}\n",
}
MORE = {
    "global-rng": ["import torch\n\ndef f(t):\n    t.uniform_(){pragma}\n",
                   "import torch\n\ndef f(n):\n    return torch.randperm(n){pragma}\n",
                   "import torch\n\ndef f(p):\n    return torch.multinomial(p, 2){pragma}\n"],
    "reference-import": ["from repro.core import graph{pragma}\n",
                         "import repro.obs.trace{pragma}\n", "import jaxlib{pragma}\n"],
}
CASES = [(rule, src) for rule, src in SNIPPETS.items()] + \
    [(rule, src) for rule, srcs in MORE.items() for src in srcs]


@pytest.mark.parametrize("rule,src", CASES)
def test_lint_rule_flags_and_pragma_silences(rule, src):
    got = RL.lint_source(src.format(pragma=""), "repro_torch/fx.py")
    assert _rules(got) == [rule]
    assert got[0].where.startswith("repro_torch/fx.py:")
    assert RL.lint_source(src.format(pragma=f"  # repo-lint: allow-{rule}"),
                          "repro_torch/fx.py") == []


def test_lint_leaves_the_sanctioned_forms_alone():
    src = ("import time\nimport torch\nimport repro_torch.core\n"
           "from repro_torch.obs import trace\n\n"
           "def f(g, clock=time.perf_counter):\n"
           "    with trace.timed('x') as tm:\n"
           "        a = torch.randn(3, generator=g)\n"
           "        a.normal_(generator=g)\n"
           "    return clock(), tm.seconds\n")
    assert RL.lint_source(src, "repro_torch/fx.py") == []
    timing = "import time\n\ndef f():\n    return time.perf_counter()\n"
    assert RL.lint_source(timing, "repro_torch/obs/trace.py") == []   # the timing layer


def test_port_lints_clean():
    assert RL.run(log=_silent) == []


# ------------------------------------------------------------------- kernel
def _spec(**kw):
    base = K.LaunchSpec(name="seed", entry="e", source="s", instance=0,
                        instance_name="k<float>", problem=(1,), grid=(8, 1, 1), threads=128)
    return dataclasses.replace(base, **kw)


@pytest.mark.parametrize("kw,rule", [
    ({"dyn_smem": 240_000, "opt_in": True}, "smem-budget"),
    ({"dyn_smem": 200_000, "static_smem": 40_000, "opt_in": True}, "smem-budget"),
    ({"dyn_smem": 60_000}, "smem-budget"),                # no opt-in above 48 KiB
    ({"threads": 100}, "threads"),
    ({"threads": 2048}, "threads"),
    ({"grid": (8, 65_536, 1)}, "grid-bounds"),
    ({"grid": (2**31, 1, 1)}, "grid-bounds"),
    ({"grid": (0, 1, 1)}, "grid-bounds"),
])
def test_kernel_check_flags_seeded_specs(kw, rule):
    assert _rules(KC.check_spec(_spec(**kw))) == [rule]


def test_kernel_check_passes_the_budget_edges():
    assert KC.check_spec(_spec(dyn_smem=K.SMEM_NO_OPT_IN)) == []
    assert KC.check_spec(_spec(dyn_smem=K.SMEM_BLOCK_MAX, opt_in=True)) == []
    assert KC.check_spec(_spec(grid=(K.GRID_X_MAX, K.GRID_YZ_MAX, K.GRID_YZ_MAX),
                               threads=1024)) == []


def test_shipped_specs_clean_and_cover_every_instance():
    specs = KC.all_specs()
    assert KC.run(log=_silent, card=False) == []
    instances = {(s.source, s.instance) for s in specs}
    assert len(instances) == 38
    per_source = {src: sorted(i for s_, i in instances if s_ == src)
                  for src in {s for s, _ in instances}}
    assert per_source == {"rng_prune": [0, 1, 2], "rng_prune_wide": [0, 1],
                          "beam_score": list(range(20)), "beam_score_pq": list(range(7)),
                          "pairwise_l2": [0, 1], "fm_interact": [0, 1],
                          "bucket_merge": [0, 1]}
    assert len({s.name for s in specs}) == len(specs)


def test_launch_specs_follow_the_launchers():
    from repro_torch.kernels.beam_score import ops as beam
    from repro_torch.kernels.rng_prune import ops as prune
    s = prune.kernel_spec(128, 1_000_000, 128, "f32")
    assert (s.entry, s.grid, s.threads, s.dyn_smem, s.blocks_per_sm) == \
        ("rng_prune", (396, 1, 1), 128, 4 * 19_072, 3)
    assert prune.kernel_spec(960, 1_000_000, 128, "int8").dyn_smem == 4 * 14_976 + 8 * 960
    assert prune.kernel_spec(128, 8, 132, "f32").entry == "rng_prune_wide"
    assert prune.kernel_spec(128, 8, 132, "f32").grid == (2, 1, 1)
    assert beam.kernel_spec("beam_score", 128, 10, "f32", aligned=False).instance_name == \
        "beam_score_kernel<float, 0, 1>"
    assert beam.kernel_spec("beam_score_int8", 960, 10).instance_name == \
        "beam_score_int8_kernel<0>"
    assert KC.mangled_fragment("beam_score_kernel<__nv_bfloat16, 32, 4>") == \
        "17beam_score_kernelI13__nv_bfloat16Li32ELi4EE"


def test_ptxas_report_parsing():
    rep = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116rng_prune_kernelI"
           "fLi4EEEvPKT_' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_116rng_prune_kernelI\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 160 registers, used 1 barriers\n")
    (entry,) = KC.ptxas_entries(rep).items()
    assert KC.mangled_fragment("rng_prune_kernel<float, 4>") in entry[0]
    assert entry[1] == {"registers": 160, "spill_stores": 8}
    row = {"source": "rng_prune", "instance": 0, "kernel": "rng_prune_kernel<float, 4>",
           "threads": 128, "dyn_smem": 76_288, "claimed_blocks_per_sm": 3, "registers": 168,
           "static_smem": 0, "local_bytes": 0, "max_threads": 128, "max_dyn_smem": 76_288,
           "blocks_per_sm": 2, "binary_version": 90, "ptxas": entry[1]}
    spec = _spec(dyn_smem=76_288, opt_in=True)
    rules = _rules(KC.check_attributes(row, spec))
    assert rules.count("registers") == 2 and rules.count("spills") == 1


# ------------------------------------------------------- baseline and CLI
class TestBaselineAndCLI:
    def test_baseline_round_trip(self, tmp_path):
        path = tmp_path / "BASELINE.json"
        f1 = B.Finding("lint", "bare-assert", "m.py:3", "detail a")
        f2 = B.Finding("dispatch", "wide-dtype", "entry:mul", "detail b")
        B.write_baseline([f1, f2, f1], path)          # duplicate collapses
        base = B.load_baseline(path)
        assert base == {f1.key, f2.key}
        f3 = B.Finding("kernel", "smem-budget", "spec", "")
        fresh = B.new_findings([f1, f3, f3, f2], base)
        assert [f.key for f in fresh] == [f3.key]     # deduped, stable order

    def test_missing_baseline_is_empty(self, tmp_path):
        assert B.load_baseline(tmp_path / "nope.json") == set()

    def test_cli_lint_pass_clean(self, capsys):
        assert cli_main(["--passes", "lint", "--check-baseline", "-q"]) == 0
        assert "0 new" in capsys.readouterr().out

    def test_cli_gate_fails_on_seeded_finding(self, tmp_path, monkeypatch, capsys):
        # seed one violation, watch the gate fail, baseline it, watch it pass
        seeded = B.Finding("lint", "bare-assert", "repro_torch/fx.py:1", "seeded")
        monkeypatch.setattr(RL, "run", lambda log=print: [seeded])
        path = tmp_path / "BASELINE.json"
        args = ["--passes", "lint", "--baseline", str(path), "-q"]
        assert cli_main(args + ["--check-baseline"]) == 1
        assert f"NEW {seeded}" in capsys.readouterr().out
        assert cli_main(args + ["--write-baseline"]) == 0
        assert cli_main(args + ["--check-baseline"]) == 0

    def test_cli_without_gate_reports_but_passes(self, monkeypatch):
        seeded = B.Finding("lint", "bare-assert", "repro_torch/fx.py:1", "seeded")
        monkeypatch.setattr(RL, "run", lambda log=print: [seeded])
        assert cli_main(["--passes", "lint", "-q"]) == 0

    def test_cli_rejects_unknown_pass(self):
        with pytest.raises(SystemExit):
            cli_main(["--passes", "nonsense"])

    def test_shipped_baseline_is_empty(self):
        assert B.load_baseline() == set()


# -------------------------------------------------------- rebuild guard
def test_recompile_guard_on_the_cpu():
    steady, growth, caps = RG.churn_workload(device="cpu")
    assert (steady, growth) == (0, 0)
    assert len(caps) == 4 and all(b == 2 * a for a, b in zip(caps, caps[1:]))
    assert RG.run(log=_silent, device="cpu") == []


def test_recompile_guard_counts_a_build(monkeypatch):
    from repro_torch.kernels import _build
    with RG.build_counter() as c:
        monkeypatch.setitem(_build.TALLY, "builds", _build.TALLY["builds"] + 1)
        assert c.so_far == 1
    assert c.count == 1


# ----------------------------------------------------------- dispatch audit
def test_dispatch_audit_flags_a_float64_op_and_a_bf16_matmul():
    a = torch.ones(4, 4)

    def leaky():
        (a * torch.tensor(2.0, dtype=torch.float64)).sum()     # f64 input: not a leak
        a.double()                                              # f32 -> f64: a leak
        a.bfloat16() @ a.bfloat16()                             # bf16 mm
        torch.tensor([1.0, 2.0]).sum().item()                   # one host sync

    got, rep = DA.audit_call("seeded", leaky)
    assert sorted((f.rule, f.where) for f in got) == [
        ("low-precision-dot", "seeded:mm"), ("wide-dtype", "seeded:_to_copy")]
    assert rep["host_syncs"] == rep["item"] == 1
    got, _ = DA.audit_call("seeded", lambda: a.bfloat16() @ a.bfloat16(), want_f32=False)
    assert got == []


def test_registered_entries_audit_clean():
    from repro_torch.analysis import registry
    names = list(registry.entries())
    assert len(names) == 27
    assert DA.run(log=_silent) == []
    assert list(registry.entries(["search_tiled@int8"])) == [
        "core/search.search_tiled@int8", "core/search.search_tiled@int8-hashed"]
