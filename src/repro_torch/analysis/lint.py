"""CLI: ``python -m repro_torch.analysis.lint <paths...> --fail-on warning``.

Exit status: 0 when no finding meets the ``--fail-on`` threshold,
1 otherwise. ``--fail-on never`` always exits 0 (report-only mode).
``--list-rules`` prints the registered catalogue and exits.

The port's copy of the JAX package's ``analysis/lint.py``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis.core import RULES, Linter


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST invariant linter: determinism, billing units, "
                    "trace/event coverage, API misuse.")
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to lint "
                             "(default: src benchmarks examples)")
    parser.add_argument("--fail-on", choices=("warning", "error", "never"),
                        default="warning",
                        help="lowest severity that fails the run "
                             "(default: warning)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    # importing Linter's default passes registers every rule
    linter = Linter()

    if args.list_rules:
        for rule in sorted(RULES.values(), key=lambda r: r.id):
            print(f"{rule.id:28s} {rule.severity:8s} {rule.description}")
        return 0

    paths = args.paths or ["src", "benchmarks", "examples"]
    findings = linter.lint_paths(paths)
    for f in findings:
        print(f.render())

    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    if findings:
        print(f"simlint: {n_err} error(s), {n_warn} warning(s)")
    else:
        print("simlint: clean")

    if args.fail_on == "never":
        return 0
    if args.fail_on == "error":
        return 1 if n_err else 0
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
