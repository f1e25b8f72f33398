"""Dispatch audit: the intent of the reference's ``jaxpr_audit``, where it is
cheap in torch.

Each registered entry point (:mod:`repro_torch.analysis.registry`) runs at
its tiny size on the CPU under a ``TorchDispatchMode`` that records every
aten op with its input and output dtypes and devices. Rules:

``wide-dtype``
    An op producing float64 when none of its tensor inputs is float64: a
    Python or numpy double leaking into f32 arithmetic (a 2x memory and
    bandwidth tax, and a different rounding from the reference's f32).

``low-precision-dot``
    A ``mm``/``bmm``/``addmm``/``matmul``/``baddbmm`` whose output is bf16
    or f16 in an entry whose config asked for f32 (every registered entry:
    the bf16 gather paths accumulate in f32 inside the kernels).

``host-syncs`` is reported, not a finding: per entry, the count of
``aten._local_scalar_dense`` (``.item()``, ``int()``, ``bool()`` of a
tensor) and of copies from a device to the host. Each is a point where the
host waits for the card, the launch-chain lever of PERF.md's open
questions.

The reference's key-taint and CLIP-scatter rules have no cheap torch
equivalent (there is no traced program to walk and no silent clip mode in
torch's indexing, which raises on an out-of-range index); they are listed
as deliberate differences in ROADMAP.md.
"""
from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.baseline import Finding

_DOTS = {"mm", "bmm", "addmm", "matmul", "baddbmm", "addbmm", "addmv", "mv", "dot"}
_LOWP = (torch.bfloat16, torch.float16)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpRecorder(TorchDispatchMode):
    """Records ``(op name, input dtypes, output dtypes, input devices,
    output devices)`` of every aten op run inside the block."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _tensors((args, kwargs or {}))
        outs = _tensors(out)
        self.ops.append((func.overloadpacket.__name__,
                         tuple(t.dtype for t in ins), tuple(t.dtype for t in outs),
                         tuple(t.device.type for t in ins),
                         tuple(t.device.type for t in outs)))
        return out


def audit_ops(name: str, ops: list[tuple], want_f32: bool = True) -> tuple[list[Finding], dict]:
    """Findings and the host-sync report of one entry's recorded ops."""
    findings: list[Finding] = []
    wide, lowp = collections.Counter(), collections.Counter()
    syncs = collections.Counter()
    for op, in_dt, out_dt, in_dev, out_dev in ops:
        if torch.float64 in out_dt and torch.float64 not in in_dt:
            wide[op] += 1
        if want_f32 and op in _DOTS and any(d in _LOWP for d in out_dt):
            lowp[op] += 1
        if op == "_local_scalar_dense":
            syncs["item"] += 1
        elif op in ("_to_copy", "copy_", "to") and "cpu" in out_dev and \
                any(d != "cpu" for d in in_dev):
            syncs["to_host"] += 1
    for op, n in sorted(wide.items()):
        findings.append(Finding("dispatch", "wide-dtype", f"{name}:{op}",
                                f"{n} aten.{op} call(s) produce float64 from inputs with no "
                                "float64: keep the arithmetic in float32"))
    for op, n in sorted(lowp.items()):
        findings.append(Finding("dispatch", "low-precision-dot", f"{name}:{op}",
                                f"{n} aten.{op} call(s) produce bf16/f16 where the config "
                                "asked for f32 accumulation"))
    return findings, {"ops": len(ops), "host_syncs": sum(syncs.values()), **syncs}


def audit_call(name: str, call, want_f32: bool = True) -> tuple[list[Finding], dict]:
    """Run ``call()`` under the recorder and audit what it dispatched."""
    with OpRecorder() as rec:
        call()
    return audit_ops(name, rec.ops, want_f32)


def run(names: list[str] | None = None, log=print) -> list[Finding]:
    from repro_torch.analysis import registry
    findings: list[Finding] = []
    for name, setup in registry.entries(names).items():
        got, rep = audit_call(name, setup())
        log(f"dispatch-audit: {name}: {rep['ops']} aten ops, host syncs "
            f"{rep['host_syncs']} (item {rep.get('item', 0)}, to host "
            f"{rep.get('to_host', 0)}), "
            f"{len(got) or 'no'} finding{'s' if len(got) != 1 else ''}")
        findings.extend(got)
    return findings
