"""Finding + baseline bookkeeping for the static-analysis passes (the port
of ``repro.analysis.baseline``).

A finding is one violation of one rule at one place; its ``key``
(``pass:rule:where``) is the stable identity compared against the checked-in
baseline (``BASELINE.json`` next to this module). The baseline exists so CI
fails on *new* findings only: a pre-existing, consciously-accepted violation
is recorded there (with ``--write-baseline``) instead of being silenced in
code. The shipped baseline is empty for ``src/repro_torch`` — keep it that way by
fixing violations rather than baselining them; the escape hatch is for
downstream forks and for staging multi-PR cleanups.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

BASELINE_PATH = pathlib.Path(__file__).parent / "BASELINE.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation. ``where`` is a stable location string — an entry
    point / kernel-spec name or a ``path:line`` — and ``detail`` is the
    human-facing explanation (not part of the baseline identity)."""

    pass_name: str     # "lint" | "kernel" | "dispatch" | "recompile" | "collectives"
    rule: str          # e.g. "wide-dtype", "smem-budget", "bare-assert"
    where: str
    detail: str = ""

    @property
    def key(self) -> str:
        return f"{self.pass_name}:{self.rule}:{self.where}"

    def __str__(self) -> str:
        msg = f"[{self.pass_name}] {self.rule} at {self.where}"
        return f"{msg}: {self.detail}" if self.detail else msg


def load_baseline(path: pathlib.Path | str = BASELINE_PATH) -> set[str]:
    path = pathlib.Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("findings", []))


def write_baseline(findings: list[Finding],
                   path: pathlib.Path | str = BASELINE_PATH) -> None:
    payload = {"findings": sorted({f.key for f in findings})}
    pathlib.Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def new_findings(findings: list[Finding],
                 baseline: set[str]) -> list[Finding]:
    """Findings not covered by the baseline, deduplicated by key, stable
    order (first occurrence wins)."""
    seen: set[str] = set()
    out = []
    for f in findings:
        if f.key in baseline or f.key in seen:
            continue
        seen.add(f.key)
        out.append(f)
    return out
