"""CLI for the port's static analysis: the JAX package's ``python -m
repro.analysis``, with the same subcommands, output and exit codes.

Usage::

    python -m repro_torch.analysis lint [PATH ...]
    python -m repro_torch.analysis verify IR.json [--plan PLAN.json]
                                                  [--policy paper|optimal]

``lint`` runs the AST rule set (default target: ``src/repro_torch``) and
exits 1 on any finding.  ``verify`` loads a ``CourierIR`` JSON (and optionally a
``PipelinePlan`` JSON; otherwise it partitions the IR itself) and runs the
plan verifier, printing every diagnostic; exits 1 on errors.
"""
from __future__ import annotations

import argparse
import sys


def _cmd_lint(args: argparse.Namespace) -> int:
    from .lint import lint_paths
    paths = args.paths or ["src/repro_torch"]
    findings = lint_paths(paths)
    for d in findings:
        print(d.format())
    print(f"{len(findings)} finding(s) in {', '.join(paths)}")
    return 1 if findings else 0


def _cmd_verify(args: argparse.Namespace) -> int:
    from ..core.ir import CourierIR
    from ..core.partition import (PipelinePlan, partition_optimal,
                                  partition_paper)

    from .diagnostics import ERROR
    from .verify import verify_plan

    with open(args.ir, encoding="utf-8") as f:
        ir = CourierIR.from_json(f.read())
    if args.plan:
        with open(args.plan, encoding="utf-8") as f:
            plan = PipelinePlan.from_json(f.read())
    elif args.policy == "paper":
        plan = partition_paper(ir)
    else:
        plan = partition_optimal(ir)
    diags = verify_plan(ir, plan)
    for d in diags:
        print(d.format())
    errors = sum(d.severity == ERROR for d in diags)
    print(f"{len(diags)} finding(s) ({errors} error(s)) for "
          f"{ir.name!r} / {plan.policy!r}")
    return 1 if errors else 0


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("lint", help="lint a source tree")
    pl.add_argument("paths", nargs="*", help="files/dirs (default "
                                              "src/repro_torch)")
    pl.set_defaults(fn=_cmd_lint)
    pv = sub.add_parser("verify", help="verify an IR/plan JSON")
    pv.add_argument("ir", help="CourierIR JSON file")
    pv.add_argument("--plan", help="PipelinePlan JSON file (default: "
                                   "partition the IR)")
    pv.add_argument("--policy", choices=("paper", "optimal"),
                    default="optimal", help="partitioner when no --plan")
    pv.set_defaults(fn=_cmd_verify)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
