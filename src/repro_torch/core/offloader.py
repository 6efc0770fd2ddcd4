"""Function Off-loader — paper Sect. III-C (Step 9) + Off-load Switcher.

Courier-FPGA compiles the generated pipeline into a shared object and swaps
it into the *running* binary via DLL injection, keeping the original path
available ("Off-load Switcher").  The PyTorch analog:

* :class:`OffloadPlan` rebinds the interposable :class:`~repro_torch.core.
  tracer.Library` call sites — ``with deploy(plan):`` makes the *same,
  unmodified* user code call the accelerated implementations.
* :class:`OffloadedFunction` is the generated wrapper: it carries the built
  pipeline, the original function, and a switch with automatic fallback —
  if the accelerated path fails, the call reverts to the original and the
  failure is logged ("maintains original processing flow before and after
  off-load").  The kernel wrappers themselves never fall back: the Switcher
  is the one place a failure turns into the original path, and its logs
  (:attr:`OffloadedFunction.fallbacks`, :attr:`OffloadPlan.fallback_log`)
  show every time it did.
* :func:`courier_offload` is the whole toolchain in one call — trace →
  database lookup → (optional) fusion → balanced partition → pipeline →
  deployable wrapper — i.e. paper Steps 1-9 "without user intervention".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from .costmodel import CostModel, synchronize
from .database import ModuleDatabase, ModuleEntry, default_db
from .ir import CourierIR
from .pipeline import BuiltPipeline, PipelineGenerator
from .placement import Placement, is_hw
from .tracer import Frontend

__all__ = ["OffloadPlan", "OffloadedFunction", "courier_offload"]


# --------------------------------------------------------------------------- #
# Call-site rebinding plan (used by ``with deploy(plan):``)
# --------------------------------------------------------------------------- #
@dataclass
class OffloadPlan:
    """fn_key → backend-kind decisions, consumed by the deploy context."""

    decisions: dict[str, str] = field(default_factory=dict)
    fallback_log: list[str] = field(default_factory=list)

    @classmethod
    def from_ir(cls, ir: CourierIR) -> "OffloadPlan":
        kinds = ((n.fn_key, Placement.parse(n.placement)) for n in ir.nodes)
        return cls(decisions={k: p.kind for k, p in kinds if p.is_assigned})

    def resolve(self, entry: ModuleEntry) -> Callable:
        want_hw = (is_hw(self.decisions.get(entry.name))
                   and entry.accelerated)
        if not want_hw:
            return entry.software

        def switched(*args: Any, **kwargs: Any):
            try:
                return entry.accelerated(*args, **kwargs)
            except Exception as e:          # Off-load Switcher fallback
                self.fallback_log.append(f"{entry.name}: {type(e).__name__}: {e}")
                return entry.software(*args, **kwargs)
        return switched


# --------------------------------------------------------------------------- #
# The deployed wrapper
# --------------------------------------------------------------------------- #
class OffloadedFunction:
    """The generated wrapper that replaces the original function.

    ``mode`` selects the path at call time (the Off-load Switcher):
      * "pipeline"  — the built mixed sw/hw pipeline (default)
      * "original"  — the untouched software path
    Any exception on the pipeline path falls back to the original and is
    recorded in :attr:`fallbacks`.
    """

    def __init__(self, original: Callable, pipeline: BuiltPipeline,
                 plan: OffloadPlan, ir: CourierIR):
        self.original = original
        self.pipeline = pipeline
        self.plan = plan
        self.ir = ir
        self.mode = "pipeline"
        self.fallbacks: list[str] = []

    def __call__(self, *args: Any):
        if self.mode == "original":
            return self.original(*args)
        try:
            return self.pipeline(*args)
        except Exception as e:              # Off-load Switcher fallback
            self.fallbacks.append(f"pipeline: {type(e).__name__}: {e}")
            return self.original(*args)

    def map(self, tokens: Iterable[Any]) -> list[Any]:
        """Pipelined execution over a token stream (the deployed fast path)."""
        if self.mode == "original":
            return [self.original(*(t if isinstance(t, tuple) else (t,)))
                    for t in tokens]
        return self.pipeline.run(tokens)

    def map_async(self, tokens: Iterable[Any], *,
                  max_in_flight: int | None = None,
                  microbatch: int = 1) -> list[Any]:
        """Token stream through the asynchronous executor (serving path):
        the same results and order as :meth:`map`, with stages issued
        eagerly under a bounded token pool and optional micro-batching (see
        :class:`repro_torch.core.executor.PipelineExecutor`)."""
        # validate before the mode branch so a bad serving config fails
        # deterministically, not only after a switch to "pipeline" mode
        if max_in_flight is not None and max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        if self.mode == "original":
            return self.map(tokens)
        return self.pipeline.run_async(tokens, max_in_flight=max_in_flight,
                                       microbatch=microbatch)

    def switch(self, mode: str) -> None:
        if mode not in ("pipeline", "original"):
            raise ValueError(mode)
        self.mode = mode

    def describe(self) -> str:
        return (f"OffloadedFunction(mode={self.mode})\n"
                + self.pipeline.describe())


# --------------------------------------------------------------------------- #
# Whole-toolchain entry point (paper Fig. 1, Steps 1-9)
# --------------------------------------------------------------------------- #
def courier_offload(fn: Callable, *example_args: Any,
                    db: ModuleDatabase | None = None,
                    cost_model: CostModel | None = None,
                    n_threads: int = 2, policy: str = "paper",
                    prefer_hw: bool = True, fuse: bool = False,
                    fused_cost_ms: Callable | None = None,
                    max_stages: int | None = None,
                    profile: bool = True, warmup: bool = True,
                    edit_ir: Callable[[CourierIR], CourierIR] | None = None,
                    ) -> OffloadedFunction:
    """Run the full Courier flow on an unmodified callable.

    The example arguments say where the app runs: tensors on a CUDA device
    run it on the card, tensors on the CPU on the host.  ``edit_ir`` is the
    paper's Steps 6-7 hook.  ``warmup`` runs the app once (and waits for the
    card) before the profiled trace, so first-call costs such as CUDA
    context set-up don't pollute the Frontend's processing times.
    """
    db = db or default_db
    frontend = Frontend(db)
    if warmup and profile:
        synchronize(fn(*example_args))
    ir, _ = frontend.trace(fn, *example_args, profile=profile)   # Steps 1-5
    if edit_ir is not None:                                      # Steps 6-7
        ir = edit_ir(ir) or ir
    gen = PipelineGenerator(db, cost_model=cost_model)           # Step 8
    pipe = gen.generate(ir, n_threads=n_threads, policy=policy,
                        prefer_hw=prefer_hw, fuse=fuse,
                        fused_cost_ms=fused_cost_ms, max_stages=max_stages)
    plan = OffloadPlan.from_ir(pipe.ir)
    return OffloadedFunction(original=fn, pipeline=pipe, plan=plan,
                             ir=pipe.ir)                          # Step 9
