"""Static analysis: the plan verifier (the legality gate before a plan
meets traffic) and the AST concurrency/style linter over the port's tree.

CLI: ``python -m repro_torch.analysis lint [PATH ...]`` /
``python -m repro_torch.analysis verify IR.json [--plan PLAN.json]``.
"""
from .diagnostics import (ERROR, WARNING, Diagnostic, PlanVerificationError,
                          verify_enabled)
from .lint import LINT_RULES, lint_paths
from .verify import VERIFY_RULES, check_plan, verify_plan, verify_rule

__all__ = ["ERROR", "WARNING", "Diagnostic", "PlanVerificationError",
           "verify_enabled", "VERIFY_RULES", "check_plan", "verify_plan",
           "verify_rule", "LINT_RULES", "lint_paths"]
