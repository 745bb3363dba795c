"""CLI: ``python -m kubeflow_rm_tpu_torch.analysis.lint [paths...]``.

Exit status: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import lint_paths
from .rules import ALL_RULES

DEFAULT_PATH = "kubeflow_rm_tpu_torch"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_rm_tpu_torch.analysis.lint",
        description="KFRM lint of the port (see analysis/lint/rules.py)")
    parser.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                        help=f"files or directories (default: "
                             f"{DEFAULT_PATH})")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable findings on stdout")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset, e.g. "
                             "KFRM006,KFRM008 (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    args = parser.parse_args(argv)

    known = {cls.rule_id: cls for cls in ALL_RULES}
    if args.list_rules:
        for rule_id, cls in sorted(known.items()):
            print(f"{rule_id}  {cls.synopsis}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = {r.strip().upper() for r in args.rules.split(",")
                    if r.strip()}
        unknown = rule_ids - set(known)
        if unknown:
            print(f"unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    findings = lint_paths(args.paths or [DEFAULT_PATH], rule_ids)
    if args.as_json:
        print(json.dumps([f.as_dict() for f in findings], indent=1))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"\n{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
