"""CLI: ``python -m kubeflow_rm_tpu_torch.analysis.torchcheck``.

The compute-path audit gate of the port: the cost model's self-check
(:func:`costmodel.selfcheck` — exact FLOPs on a known matmul, the
donation double-buffer proof, loop trip accounting). Exit status: 0
clean, 1 a failed self-check, 2 usage error — the JAX gate's contract.

The JAX gate (``python -m kubeflow_rm_tpu.analysis.jaxcheck``) also runs
lint rules KFRM006-008 over ``jax.jit`` sites. Their torch counterparts
need a copy of ``analysis/lint`` in the port; until then this gate runs
the self-check alone.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_rm_tpu_torch.analysis.torchcheck",
        description="the port's program audit: cost-model self-check")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable report on stdout")
    args = parser.parse_args(argv)

    from .costmodel import selfcheck
    failures = selfcheck()

    if args.as_json:
        print(json.dumps({"findings": [], "selfcheck_failures": failures},
                         indent=1))
    else:
        for msg in failures:
            print(f"costmodel selfcheck: {msg}")
        if failures:
            print(f"\n{len(failures)} selfcheck failure(s)", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
