"""Static plan verification (the legality gate before a plan meets traffic)."""
from .diagnostics import (ERROR, WARNING, Diagnostic, PlanVerificationError,
                          verify_enabled)
from .verify import VERIFY_RULES, check_plan, verify_plan, verify_rule

__all__ = ["ERROR", "WARNING", "Diagnostic", "PlanVerificationError",
           "verify_enabled", "VERIFY_RULES", "check_plan", "verify_plan",
           "verify_rule"]
