"""Static-analysis layer of the port: invariants the test suite can't see
(the port of ``repro.analysis``).

The tests prove the port computes the right numbers at test scale. This
package proves a different class of property — resource, dtype and
shape contracts that only cost anything at production scale:

=========== ============================================================
pass        what it proves
=========== ============================================================
lint        AST lint of ``src/repro_torch``: bare asserts, ad-hoc
            wall-clock timing, torch samplers without an explicit
            generator, imports of jax or the JAX package
            (:mod:`repro_torch.analysis.repo_lint`).
kernel      Evaluates every hand kernel's launch shape
            (:mod:`repro_torch.kernels.spec`, exported by each kernel
            package's ``ops.py``) at the registered problem sizes and
            their edges: shared memory per block against the sm_90a
            budget and the launcher's opt-in, threads a block, grid
            bounds. On the card it also reads each instance's attributes
            (registers, spills, occupancy) and checks the Python spec
            against the ``<entry>_launch_shape`` export every source's
            launcher calls (:mod:`repro_torch.analysis.kernel_check`).
dispatch    Runs every registered public entry point
            (:mod:`repro_torch.analysis.registry`) at a tiny size on the
            CPU under a dispatch mode that records each aten op: float64
            out of f32 inputs, bf16/f16 matmuls where f32 was asked for,
            and each entry's host syncs (reported, not a finding)
            (:mod:`repro_torch.analysis.dispatch_audit`).
recompile   The reference's scripted streaming churn: steady-state
            insert/delete/search builds no kernel and opens no library;
            capacity grows on the power-of-two schedule
            (:mod:`repro_torch.analysis.recompile_guard`; on the card when
            one is present, else on the CPU, where no kernel exists).
collectives The row-sharded build's ring bytes (``mesh.stats``) against
            the closed form of ``core/shard.py``'s exchange, at D = 2
            gloo ranks (:mod:`repro_torch.analysis.collectives`; it spawns
            ranks, so it runs only when named).
=========== ============================================================

The reference's jaxpr rules for key taint and CLIP-mode scatters, its
``accum-dtype`` kernel rule and its ``hardcoded-interpret`` lint rule have
no pass here: there is no traced program to taint-walk, the card parity
checks hold each kernel's accumulation against its f32 plain version, and
a CUDA kernel has no interpret mode.

CLI
---
::

    PYTHONPATH=src python -m repro_torch.analysis                  # default passes
    PYTHONPATH=src python -m repro_torch.analysis --passes lint,kernel
    PYTHONPATH=src python -m repro_torch.analysis --only beam      # filter entries
    PYTHONPATH=src python -m repro_torch.analysis --check-baseline # CI gate
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline # accept current

Default passes are ``lint,kernel,dispatch`` (seconds on the CPU; the
kernel pass adds the card-only rules when a card is present);
``recompile`` and ``collectives`` join by name.

Baseline workflow
-----------------
``--check-baseline`` exits non-zero on any finding whose key
(``pass:rule:where``) is absent from ``BASELINE.json`` — so CI fails on
*new* violations while a consciously-accepted one can be recorded with
``--write-baseline``. The shipped baseline is **empty**: ``src/repro_torch``
is clean under every pass (fix, or in the rare legitimate case suppress in
place with a ``# repo-lint: allow-<rule>`` pragma and its reason).
"""
from repro_torch.analysis.baseline import (BASELINE_PATH, Finding, load_baseline,
                                           new_findings, write_baseline)

__all__ = ["BASELINE_PATH", "Finding", "load_baseline", "new_findings",
           "write_baseline"]
