"""CLI: ``python -m kubeflow_rm_tpu_torch.analysis.torchcheck [paths...]``.

The audit gate of the port (counterpart of ``python -m
kubeflow_rm_tpu.analysis.jaxcheck``): runs every lint rule of the port,
KFRM001-008 (``analysis/lint``: the locking rules, then a scalar sync in
a hot region inside a loop, a ``torch.compile`` or CUDA graph built in a
loop, carried state rebuilt out of place in a loop), over the tree AND
the cost model's self-check (:func:`costmodel.selfcheck` — exact FLOPs on a known matmul,
the donation double-buffer proof, loop trip accounting). Exit status: 0
clean, 1 findings or a failed self-check, 2 usage error — the same
contract as ``analysis.lint``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..lint import ALL_RULES, lint_paths

#: the rules this gate runs: all of the port's
TORCHCHECK_RULES = frozenset(cls.rule_id for cls in ALL_RULES)
DEFAULT_PATH = "kubeflow_rm_tpu_torch"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_rm_tpu_torch.analysis.torchcheck",
        description="the port's program audit: lint rules KFRM001-008 "
                    "+ cost-model self-check")
    parser.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                        help=f"files or directories (default: "
                             f"{DEFAULT_PATH})")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable report on stdout")
    parser.add_argument("--no-selfcheck", action="store_true",
                        help="skip the cost-model self-check (lint only)")
    args = parser.parse_args(argv)

    findings = lint_paths(args.paths or [DEFAULT_PATH],
                          set(TORCHCHECK_RULES))

    failures: list[str] = []
    if not args.no_selfcheck:
        from .costmodel import selfcheck
        failures = selfcheck()

    if args.as_json:
        print(json.dumps({
            "findings": [f.as_dict() for f in findings],
            "selfcheck_failures": failures,
        }, indent=1))
    else:
        for f in findings:
            print(f.render())
        for msg in failures:
            print(f"costmodel selfcheck: {msg}")
        if findings or failures:
            print(f"\n{len(findings)} finding(s), "
                  f"{len(failures)} selfcheck failure(s)",
                  file=sys.stderr)
    return 1 if (findings or failures) else 0


if __name__ == "__main__":
    sys.exit(main())
