"""Hopper launch-shape check of the hand kernels (the port's counterpart of
``repro.analysis.kernel_check``): consumes the launch specs every kernel
package exports (``kernel_spec()``/``default_specs()`` in its ``ops.py``,
:mod:`repro_torch.kernels.spec`) and turns each kernel's resource contract
into checked inequalities.

Evaluated on the CPU, at the registered problems and their edges:

``smem-budget``
    Static plus dynamic shared memory of a block stays within sm_90's
    232,448 B, and dynamic shared memory above 49,152 B appears only where
    the spec says the launcher opts in (``cudaFuncSetAttribute``); without
    the opt-in such a launch fails at run time.

``threads``
    Threads a block: a multiple of 32, at most 1,024.

``grid-bounds``
    grid.x within 1 .. 2^31 - 1, grid.y and grid.z within 1 .. 65,535.

On the card (``torch.cuda.is_available()``), additionally:

``launch-shape``
    Each spec equals what its source's ``<entry>_launch_shape`` export
    writes for the same problem: the function its launcher takes the
    launch from, so the Python mirror cannot drift from the launch.

``registers``
    Per instance, from ``cudaFuncGetAttributes`` (read through the
    source's ``<source>_func_attrs`` query): the registers of the claimed
    resident blocks fit the SM's 65,536 (allocated a warp at a time in
    units of 256), the runtime's occupancy reaches the claimed blocks an
    SM, and the count is the one ``-Xptxas -v`` reported for the instance
    (``kernels/_build.py`` keeps each library's report beside it).

``spills``
    Local (spill) bytes a thread are 0, in the attributes and in the
    ``-Xptxas -v`` report.

The reference's ``accum-dtype`` rule maps to the parity checks that hold
each kernel against its f32 plain version on the card; it needs no check
here. Its ``oob-index-map`` rule has no counterpart: a hand kernel bounds
its own reads (each documents how it reads an id outside [0, n)).
"""
from __future__ import annotations

import ctypes
import re

from repro_torch.analysis.baseline import Finding
from repro_torch.kernels import spec as K


def all_specs(sms: int = K.H100_SMS) -> list[K.LaunchSpec]:
    from repro_torch.kernels.beam_score import ops as beam
    from repro_torch.kernels.bucket_merge import ops as bm
    from repro_torch.kernels.fm_interact import ops as fm
    from repro_torch.kernels.pairwise_l2 import ops as pl2
    from repro_torch.kernels.rng_prune import ops as prune
    return [*prune.default_specs(sms), *beam.default_specs(), *pl2.default_specs(),
            *fm.default_specs(), *bm.default_specs()]


# ------------------------------------------------------------------ static
def check_spec(spec: K.LaunchSpec, static_smem: int | None = None) -> list[Finding]:
    """The CPU rules on one spec. ``static_smem``: the card's static shared
    bytes of the instance, in place of the spec's, when known."""
    out = []
    static = spec.static_smem if static_smem is None else static_smem
    total = static + spec.dyn_smem
    if total > K.SMEM_BLOCK_MAX:
        out.append(Finding(
            "kernel", "smem-budget", spec.name,
            f"{total} B of shared memory a block ({static} static + {spec.dyn_smem} "
            f"dynamic) exceeds sm_90's {K.SMEM_BLOCK_MAX} B"))
    if spec.dyn_smem > K.SMEM_NO_OPT_IN and not spec.opt_in:
        out.append(Finding(
            "kernel", "smem-budget", spec.name,
            f"{spec.dyn_smem} B of dynamic shared memory without the launcher's opt-in "
            f"(above {K.SMEM_NO_OPT_IN} B the launch fails unless "
            "cudaFuncAttributeMaxDynamicSharedMemorySize is raised)"))
    if spec.threads % 32 or not 32 <= spec.threads <= K.MAX_THREADS:
        out.append(Finding(
            "kernel", "threads", spec.name,
            f"{spec.threads} threads a block: need a multiple of 32 within "
            f"32 .. {K.MAX_THREADS}"))
    x, y, z = spec.grid
    if not (1 <= x <= K.GRID_X_MAX and 1 <= y <= K.GRID_YZ_MAX and 1 <= z <= K.GRID_YZ_MAX):
        out.append(Finding(
            "kernel", "grid-bounds", spec.name,
            f"grid {spec.grid}: x must lie in 1 .. {K.GRID_X_MAX}, y and z in "
            f"1 .. {K.GRID_YZ_MAX}"))
    return out


# ------------------------------------------------------------- on the card
_MANGLED_TYPES = {"float": "f", "int8_t": "a", "__nv_bfloat16": "13__nv_bfloat16"}


def mangled_fragment(instance_name: str) -> str:
    """``rng_prune_kernel<float, 4>`` -> ``16rng_prune_kernelIfLi4EE``: the
    part of the Itanium-mangled name that names the template instance."""
    base, _, rest = instance_name.partition("<")
    args = [a.strip() for a in rest.rstrip(">").split(",") if a.strip()]
    enc = "".join(_MANGLED_TYPES[a] if a in _MANGLED_TYPES else f"Li{int(a)}E" for a in args)
    return f"{len(base)}{base}I{enc}E"


def ptxas_entries(report: str) -> dict[str, dict]:
    """{mangled entry: {"registers", "spill_stores"}} from an ``-Xptxas -v``
    report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": None, "spill_stores": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            cur["spill_stores"] = max(cur["spill_stores"], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _query(entry: str, source: str, args, n_out: int) -> tuple[int, list[int]]:
    from repro_torch.kernels import _build
    fn = _build.load(entry, "i" * len(args) + "p", source=source)
    out = (ctypes.c_int * n_out)()
    rc = fn(*args, ctypes.addressof(out))
    return rc, list(out)


def launch_export(spec: K.LaunchSpec) -> tuple[int, tuple[int, ...]]:
    """(cudaError_t, out[8]) of ``<entry>_launch_shape`` for the spec's
    problem."""
    rc, out = _query(f"{spec.entry}_launch_shape", spec.source, spec.problem, 8)
    return rc, tuple(out)


def func_attrs(source: str, instance: int, dyn_smem: int) -> dict:
    """The instance's attributes through ``<source>_func_attrs``."""
    rc, out = _query(f"{source}_func_attrs", source, (instance, dyn_smem), 7)
    if rc != 0:
        raise RuntimeError(f"{source}_func_attrs({instance}, {dyn_smem}): cudaError_t {rc}")
    keys = ("registers", "static_smem", "local_bytes", "max_threads", "max_dyn_smem",
            "blocks_per_sm", "binary_version")
    return dict(zip(keys, out))


def card_attributes(specs: list[K.LaunchSpec]) -> list[dict]:
    """One row per (instance, dynamic shared size) of ``specs``: the card's
    attributes beside the spec's claims and the ``-Xptxas -v`` report."""
    from repro_torch.kernels import _build
    _build.build_all(sorted({s.source for s in specs}))
    reports = {}
    rows, seen = [], set()
    for s in specs:
        key = (s.source, s.instance, s.dyn_smem)
        if key in seen:
            continue
        seen.add(key)
        if s.source not in reports:
            path = _build.ptxas_path(s.source)
            reports[s.source] = ptxas_entries(path.read_text()) if path.exists() else None
        att = func_attrs(s.source, s.instance, s.dyn_smem)
        frag = mangled_fragment(s.instance_name)
        rep = reports[s.source]
        hits = [v for k, v in (rep or {}).items() if frag in k]
        rows.append({"source": s.source, "instance": s.instance,
                     "kernel": s.instance_name, "spec": s.name, "threads": s.threads,
                     "dyn_smem": s.dyn_smem, "claimed_blocks_per_sm": s.blocks_per_sm,
                     **att,
                     "ptxas": None if rep is None else (hits[0] if len(hits) == 1 else
                                                        {"matches": len(hits)})})
    return rows


def check_attributes(row: dict, spec: K.LaunchSpec) -> list[Finding]:
    """The card rules on one instance's attributes."""
    out = []
    where = f"{row['source']}#{row['instance']}:{row['kernel']}"
    warps = K.cdiv(row["threads"], 32)
    regs_warp = K.cdiv(row["registers"] * 32, 256) * 256
    claim = row["claimed_blocks_per_sm"]
    if warps * regs_warp * claim > K.REGS_PER_SM or row["blocks_per_sm"] < claim:
        out.append(Finding(
            "kernel", "registers", where,
            f"{row['registers']} registers x {row['threads']} threads: {claim} blocks an SM "
            f"claimed, {row['blocks_per_sm']} resident at {row['dyn_smem']} B dynamic "
            f"({warps * regs_warp * claim} of {K.REGS_PER_SM} registers)"))
    if row["threads"] > row["max_threads"]:
        out.append(Finding("kernel", "threads", where,
                           f"{row['threads']} threads over the instance's "
                           f"{row['max_threads']}"))
    if row["local_bytes"] != 0:
        out.append(Finding("kernel", "spills", where,
                           f"{row['local_bytes']} local bytes a thread (spills)"))
    rep = row["ptxas"]
    if rep is not None:
        if "registers" not in rep:
            out.append(Finding("kernel", "registers", where,
                               f"-Xptxas -v names the instance {rep['matches']} times "
                               f"({mangled_fragment(row['kernel'])})"))
        else:
            if rep["registers"] != row["registers"]:
                out.append(Finding("kernel", "registers", where,
                                   f"-Xptxas -v reported {rep['registers']} registers, "
                                   f"the card {row['registers']}"))
            if rep["spill_stores"]:
                out.append(Finding("kernel", "spills", where,
                                   f"-Xptxas -v reported {rep['spill_stores']} bytes of "
                                   "spill stores"))
    out += check_spec(spec, static_smem=row["static_smem"])
    if row["static_smem"] != spec.static_smem:
        out.append(Finding("kernel", "smem-budget", where,
                           f"{row['static_smem']} B of static shared memory on the card, "
                           f"{spec.static_smem} B in the spec"))
    return out


def check_card(specs: list[K.LaunchSpec], log=print) -> tuple[list[Finding], list[dict]]:
    """The card rules over ``specs``: every export against its spec, every
    instance's attributes. Returns (findings, attribute rows)."""
    findings = []
    rows = card_attributes(specs)
    by_key = {(s.source, s.instance, s.dyn_smem): s for s in specs}
    for row in rows:
        got = check_attributes(row, by_key[(row["source"], row["instance"], row["dyn_smem"])])
        log(f"kernel-check card: {row['kernel']} ({row['source']}#{row['instance']}): "
            f"{row['registers']} registers, {row['static_smem']} B static + "
            f"{row['dyn_smem']} B dynamic shared, {row['local_bytes']} B local, "
            f"{row['threads']} threads, {row['blocks_per_sm']} blocks an SM "
            f"(claimed {row['claimed_blocks_per_sm']}): "
            f"{len(got) or 'no'} finding{'s' if len(got) != 1 else ''}")
        findings += got
    for s in specs:
        rc, got = launch_export(s)
        if rc != 0 or got != s.export():
            findings.append(Finding(
                "kernel", "launch-shape", s.name,
                f"{s.entry}_launch_shape{s.problem} -> rc {rc}, {got}; the spec says "
                f"{s.export()}"))
    return findings, rows


def run(names: list[str] | None = None, log=print, card: bool | None = None) -> list[Finding]:
    """The CPU rules over every registered spec; on the card (``card`` None:
    when one is present) the card rules too."""
    import torch
    if card is None:
        card = torch.cuda.is_available()
    sms = (torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
           if card else K.H100_SMS)
    specs = [s for s in all_specs(sms) if not names or any(n in s.name for n in names)]
    findings: list[Finding] = []
    for s in specs:
        got = check_spec(s)
        log(f"kernel-check: {s.name}: grid={s.grid} threads={s.threads} "
            f"smem={s.static_smem}+{s.dyn_smem} B, "
            f"{len(got) or 'no'} finding{'s' if len(got) != 1 else ''}")
        findings += got
    if card:
        findings += check_card(specs, log)[0]
    return findings
