"""CLI: ``python -m blendjax_torch.analysis [paths...]`` (default: the
``blendjax_torch`` package; with ``--contracts``, ``chip_smoke.py`` too).

Exit status: 0 when every finding is inline-suppressed or baselined,
1 when unsuppressed findings remain, 2 on usage errors, 3 when
``--project`` (the default) or ``--contracts`` needs every module
parsed but one failed (fix the syntax error or rerun with
``--no-project``), 4 when ``--max-seconds`` is set and the run
overshot it (the CI wall-time budget). Runs with no third-party
imports so it works offline and inside Blender's Python.

Modes beyond the lint rules:

- ``--contracts`` runs the contract-drift gate (BJX123) instead of
  the rules: metric names, wire stamp keys, and ``BLENDJAX_*`` env
  knobs extracted from code, cross-checked against
  ``blendjax_torch/docs/``.
- ``--strict-suppressions`` adds the suppression-hygiene audit
  (BJX124): every ``# bjx: ignore[...]`` must say why. On in CI.
- ``--format sarif`` emits SARIF 2.1.0 for code-scanning upload.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from blendjax_torch.analysis.contracts import check_contracts
from blendjax_torch.analysis.core import (
    BASELINE_DEFAULT,
    Finding,
    all_rules,
    analyze_modules,
    analyze_project_modules,
    apply_baseline,
    check_suppression_hygiene,
    load_baseline,
    parse_paths,
    write_baseline,
)

# One-line descriptions for the flag-gated passes that are not in the
# rule registry (SARIF requires a description per reported ruleId).
_EXTRA_RULE_DESCRIPTIONS = {
    "BJX123": "contract drift between code catalogs and blendjax_torch/docs/",
    "BJX124": "suppression marker without a justification",
}


def render_sarif(findings: list[Finding]) -> str:
    """Minimal SARIF 2.1.0 document: one run, one result per finding,
    with the baseline-v2 identity carried as a partial fingerprint so
    code-scanning dedupe survives line shifts the same way the
    baseline does."""
    known = all_rules()
    rules = []
    for rule_id in sorted({f.rule for f in findings}):
        rule = known.get(rule_id)
        description = (
            rule.description
            if rule is not None
            else _EXTRA_RULE_DESCRIPTIONS.get(rule_id, rule_id)
        )
        rules.append(
            {"id": rule_id, "shortDescription": {"text": description}}
        )
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "warning",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {
                            "startLine": f.line,
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if f.identity:
            result["partialFingerprints"] = {"bjxIdentity/v2": f.identity}
        results.append(result)
    doc = {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "bjx-lint",
                        "informationUri": "blendjax_torch/docs/static-analysis.md",
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m blendjax_torch.analysis",
        description="bjx-lint: capture, host-sync, thread, socket and "
        "contract checks for blendjax_torch",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files or directories to analyze (default: blendjax_torch; "
        "with --contracts: blendjax_torch plus chip_smoke.py)",
    )
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--project", action=argparse.BooleanOptionalAction, default=True,
        help="run the whole-program pass (BJX117+) over one shared "
        "parse (default on; --no-project is the producer-side quick "
        "path — per-file rules only)",
    )
    parser.add_argument(
        "--baseline", default=BASELINE_DEFAULT,
        help=f"baseline file (default: {BASELINE_DEFAULT})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report baselined findings too",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="grandfather all current findings into the baseline file",
    )
    parser.add_argument(
        "--max-seconds", type=float, default=None,
        help="fail (exit 4) if the analysis takes longer than this "
        "wall-time budget (the CI lint-latency gate)",
    )
    parser.add_argument(
        "--contracts", action="store_true",
        help="run the contract-drift gate instead of the lint rules: "
        "cross-check metric names, wire stamp keys, and BLENDJAX_* "
        "env knobs against blendjax_torch/docs/ (exit 1 on drift)",
    )
    parser.add_argument(
        "--strict-suppressions", action="store_true",
        help="require a justification on every '# bjx: ignore[...]' "
        "marker — same line or the comment line above (on in CI)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule ids and exit",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()
    if args.list_rules:
        for rule_id, rule in sorted(rules.items()):
            scope = "project" if rule.project else "file"
            print(f"{rule_id} {rule.name} [{scope}]: {rule.description}")
        return 0
    select = None
    if args.select:
        select = {r.strip().upper() for r in args.select.split(",") if r.strip()}
        unknown = select - set(rules)
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)}", file=sys.stderr)
            return 2
    paths = args.paths
    if not paths:
        # The contracts gate audits chip_smoke.py too: it drives the
        # port's main path on the card and lives outside the package
        # tree.
        paths = ["blendjax_torch"]
        if args.contracts and os.path.exists("chip_smoke.py"):
            paths.append("chip_smoke.py")
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"no such path: {missing}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    root = os.getcwd()
    modules, errors = parse_paths(paths, root=root)

    if args.contracts:
        if errors:
            for f in errors:
                print(f.render(), file=sys.stderr)
            print(
                f"--contracts needs every module parsed; {len(errors)} "
                "file(s) failed (see above) — the catalogs would be "
                "extracted from a partial project.",
                file=sys.stderr,
            )
            return 3
        findings = check_contracts(modules, root)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        _emit(findings, args.format, footer=(
            "contract drift: update the table in blendjax_torch/docs/ "
            "or the code catalog."
        ))
        return _budget_exit(args, t0, bool(findings))

    findings = errors + analyze_modules(modules, select=select)
    if args.project:
        if errors:
            # Never silently fall back to per-file-only results: a
            # parse failure means the spawn graph (and every BJX117+
            # verdict) would be built from a partial project.
            for f in errors:
                print(f.render(), file=sys.stderr)
            print(
                f"--project needs every module parsed; {len(errors)} "
                "file(s) failed (see above) — fix the syntax error or "
                "rerun with --no-project for per-file results only.",
                file=sys.stderr,
            )
            return 3
        findings.extend(analyze_project_modules(modules, select=select))
    if args.strict_suppressions:
        findings.extend(check_suppression_hygiene(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    if args.write_baseline:
        n = write_baseline(args.baseline, findings, root)
        print(f"wrote {n} finding(s) to {args.baseline}")
        return 0
    if not args.no_baseline:
        findings = apply_baseline(
            findings, load_baseline(args.baseline), root
        )

    _emit(findings, args.format, footer=(
        "Suppress one site with '# bjx: ignore[RULE]' or grandfather "
        "all with --write-baseline (see blendjax_torch/docs/static-analysis.md)."
    ))
    return _budget_exit(args, t0, bool(findings))


def _emit(findings: list[Finding], fmt: str, footer: str) -> None:
    if fmt == "json":
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    elif fmt == "sarif":
        print(render_sarif(findings))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"\n{len(findings)} finding(s). {footer}")


def _budget_exit(args, t0: float, found: bool) -> int:
    elapsed = time.perf_counter() - t0
    if args.max_seconds is not None and elapsed > args.max_seconds:
        print(
            f"bjx-lint took {elapsed:.2f}s, over the --max-seconds "
            f"budget of {args.max_seconds:.2f}s",
            file=sys.stderr,
        )
        return 4
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
