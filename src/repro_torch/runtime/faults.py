"""Deterministic fault injection for the executor's retry and quarantine
paths and for the training loop's checkpoint-restart.

Testing that a pipeline survives a failing stage without a chip to unplug
needs scripted faults:

* :class:`FaultPlan` — a builder that scripts *what* fails and *when*, in
  terms of deterministic invocation counts (never wall clock):
  ``transient(stage, at_calls=...)`` raises :class:`InjectedFault` on the
  N-th invocation of a stage; ``lose_device(ordinal, after_calls=...)``
  makes every stage call placed on that device ordinal raise
  :class:`DeviceLostError` permanently — the scripted analog of a card
  dropping out; ``fail_step(at_steps=...)`` scripts training-step faults, each firing
  once, so a checkpoint-restart replay of the same step succeeds.

* :class:`FaultInjector` — the built plan, hooked into the executor's
  stage call-sites (``PipelineExecutor(fault_injector=...)`` calls
  :meth:`FaultInjector.on_stage_call` before every stage body) and into
  the training loop (``FaultTolerantDriver(faults=...)`` calls
  :meth:`FaultInjector.on_step`; a legacy ``fail_hook(step)`` callback is
  wrapped by :meth:`FaultInjector.from_hook`).  Injection happens BEFORE
  the stage function runs, so a retried call never re-executes a stage
  that already wrote part of its output.

The injector is also scriptable *after* construction (``lose_device`` on a
live injector).  The JAX package's ``slowdown`` and ``random_transients``
scripts (for its replication and chaos benchmarks) and elastic-inventory
helpers (``surviving``, ``remap_devices``) wait for the slices that use
them.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterable

__all__ = ["FaultPlan", "FaultInjector", "InjectedFault", "DeviceLostError",
           "as_injector"]


class InjectedFault(RuntimeError):
    """A scripted transient failure (see :meth:`FaultPlan.transient`)."""


class DeviceLostError(InjectedFault):
    """A scripted permanent device loss: every stage call placed on the
    lost ordinal raises this, from the scripted trigger point on."""

    def __init__(self, msg: str, ordinal: int):
        super().__init__(msg)
        self.ordinal = ordinal


class FaultPlan:
    """Deterministic fault script, built fluently and compiled by
    :meth:`build` into a :class:`FaultInjector`.

    All triggers are INVOCATION COUNTS (0-based, per stage or per device
    ordinal), never wall-clock times — the same plan replays identically
    under any scheduler.  A retried stage call is a *new* invocation, so a
    single scripted transient is survived by one retry unless the plan
    scripts the retry's count too.
    """

    def __init__(self) -> None:
        self.transients: dict[int, set[int]] = {}     # stage -> call counts
        self.device_losses: dict[int, int] = {}       # ordinal -> after_calls
        self.step_faults: set[int] = set()            # training steps

    def transient(self, stage: int, at_calls: Iterable[int]) -> "FaultPlan":
        """Raise :class:`InjectedFault` on the given invocation counts of
        ``stage`` (counted across all replicas of the stage)."""
        self.transients.setdefault(int(stage), set()).update(
            int(c) for c in at_calls)
        return self

    def lose_device(self, ordinal: int, *, after_calls: int = 0) -> "FaultPlan":
        """Permanently lose device ``ordinal`` once ``after_calls`` stage
        calls have been placed on it: that call and every later one on the
        ordinal raise :class:`DeviceLostError`."""
        self.device_losses[int(ordinal)] = int(after_calls)
        return self

    def fail_step(self, at_steps: Iterable[int]) -> "FaultPlan":
        """Raise :class:`InjectedFault` at the given training steps — each
        fires ONCE, so a checkpoint-restart replay of the step succeeds."""
        self.step_faults.update(int(s) for s in at_steps)
        return self

    def build(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """A compiled :class:`FaultPlan`, hooked into executors.

    Thread-safe: the invocation counters are the only shared state and
    live behind one lock; the fault decision for an invocation depends
    only on its count, so concurrent replicas see a deterministic
    schedule.  Counters (``injected``/``slowed``/``device_faults``) make
    the injected load auditable from benchmarks.
    """

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan or FaultPlan()
        self._lock = threading.Lock()
        self._stage_calls: dict[int, int] = {}
        self._device_calls: dict[int, int] = {}
        self._lost: set[int] = set()          # ordinals whose loss triggered
        self._steps_fired: set[int] = set()
        self._hook: Callable[[int], None] | None = None
        self.injected = 0                     # transient faults raised
        self.device_faults = 0                # device-loss faults raised

    @classmethod
    def from_hook(cls, hook: Callable[[int], None]) -> "FaultInjector":
        """Wrap a legacy ``fail_hook(step)`` callback so training code has
        one injection API."""
        inj = cls()
        inj._hook = hook
        return inj

    # -- live scripting (benchmarks pull devices mid-run) -------------------- #
    def lose_device(self, ordinal: int, *, after_calls: int = 0) -> None:
        """Script a device loss on a LIVE injector (counted from the calls
        already placed on the ordinal)."""
        with self._lock:
            base = self._device_calls.get(int(ordinal), 0)
            self.plan.device_losses[int(ordinal)] = base + int(after_calls)

    # -- executor hook -------------------------------------------------------- #
    def on_stage_call(self, stage: int, *, replica: int | None = None,
                      device: int | None = None) -> None:
        """Called by the executor before every stage body.  Raises the
        scripted fault for this invocation; returns normally otherwise."""
        plan = self.plan
        with self._lock:
            n = self._stage_calls.get(stage, 0)
            self._stage_calls[stage] = n + 1
            if device is not None:
                dn = self._device_calls.get(device, 0)
                self._device_calls[device] = dn + 1
                cut = plan.device_losses.get(device)
                if cut is not None and dn >= cut:
                    self._lost.add(device)
                    self.device_faults += 1
                    raise DeviceLostError(
                        f"injected device loss: ordinal {device} "
                        f"(stage {stage} replica {replica}, device call "
                        f"{dn})", device)
            if n in plan.transients.get(stage, ()):
                self.injected += 1
                raise InjectedFault(
                    f"injected transient: stage {stage} call {n}"
                    + (f" (replica {replica})" if replica is not None else ""))

    # -- training hook -------------------------------------------------------- #
    def on_step(self, step: int) -> None:
        """Called by the training driver before each step; raises the
        scripted step fault (once per scripted step)."""
        if self._hook is not None:
            self._hook(step)
            return
        with self._lock:
            if step in self.plan.step_faults and step not in self._steps_fired:
                self._steps_fired.add(step)
                self.injected += 1
                raise InjectedFault(f"injected step fault at step {step}")

    # -- queries --------------------------------------------------------------- #
    def lost_ordinals(self) -> frozenset[int]:
        """Ordinals whose scripted loss has TRIGGERED (a loss scripted but
        never hit by a stage call is not yet observable, exactly like a
        real chip that failed while idle and unprobed)."""
        with self._lock:
            return frozenset(self._lost)

    def stage_calls(self, stage: int) -> int:
        with self._lock:
            return self._stage_calls.get(stage, 0)

    def stats(self) -> dict:
        with self._lock:
            return {"injected": self.injected,
                    "device_faults": self.device_faults,
                    "lost_ordinals": sorted(self._lost)}


def as_injector(faults: Any) -> FaultInjector | None:
    """Normalize a ``faults=`` argument: a plan is built, an injector
    passes through, ``None`` stays ``None``."""
    if faults is None or isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return faults.build()
    raise TypeError(f"faults must be a FaultPlan or FaultInjector, "
                    f"got {type(faults).__name__}")
