"""CLI entry point: ``python -m repro_torch.analysis`` — see the package docstring."""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import baseline as B

PASSES = ("lint", "kernel", "dispatch", "recompile", "collectives")
DEFAULT_PASSES = ("lint", "kernel", "dispatch")


def _run_pass(name: str, only: list[str] | None, log) -> list[B.Finding]:
    if name == "lint":
        from repro_torch.analysis import repo_lint
        return repo_lint.run(log=log)
    if name == "dispatch":
        from repro_torch.analysis import dispatch_audit
        return dispatch_audit.run(only, log=log)
    if name == "kernel":
        from repro_torch.analysis import kernel_check
        return kernel_check.run(only, log=log)
    if name == "recompile":
        from repro_torch.analysis import recompile_guard
        return recompile_guard.run(log=log)
    if name == "collectives":
        from repro_torch.analysis import collectives
        return collectives.run(log=log)
    raise ValueError(f"unknown pass {name!r}: expected one of {PASSES}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static-analysis passes (see repro_torch/analysis/__init__.py)")
    ap.add_argument("--passes", default=",".join(DEFAULT_PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)} "
                         f"(default: {','.join(DEFAULT_PASSES)})")
    ap.add_argument("--only", default="",
                    help="comma-separated entry-point / kernel name filter "
                         "(substring match; kernel + dispatch passes)")
    ap.add_argument("--check-baseline", action="store_true",
                    help="exit 1 on findings not in the baseline (CI gate)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into BASELINE.json")
    ap.add_argument("--baseline", default=str(B.BASELINE_PATH),
                    help="baseline path (default: the checked-in one)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-entry progress lines")
    args = ap.parse_args(argv)

    log = (lambda *a, **k: None) if args.quiet else print
    only = [s for s in args.only.split(",") if s] or None
    passes = [s.strip() for s in args.passes.split(",") if s.strip()]
    for p in passes:
        if p not in PASSES:
            ap.error(f"unknown pass {p!r}: expected one of {','.join(PASSES)}")

    findings: list[B.Finding] = []
    for p in passes:
        findings.extend(_run_pass(p, only, log))

    if args.write_baseline:
        B.write_baseline(findings, args.baseline)
        print(f"wrote {len(set(f.key for f in findings))} finding keys to "
              f"{args.baseline}")
        return 0

    base = B.load_baseline(args.baseline)
    fresh = B.new_findings(findings, base)
    known = len(findings) - len(fresh)
    for f in fresh:
        print(f"NEW {f}")
    print(f"analysis: {len(passes)} pass(es), {len(findings)} finding(s) "
          f"({known} baselined, {len(fresh)} new)")
    if args.check_baseline and fresh:
        print("FAIL: new findings vs baseline — fix them, or (for a "
              "consciously-accepted violation) re-run with --write-baseline",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
