"""Fault-tolerant training driver and straggler monitor.

The port of the JAX package's ``runtime/driver.py`` training half:

* :class:`FaultTolerantDriver` — checkpoint/restart training loop: periodic
  (async) checkpoints, automatic reload-and-continue on step failure with
  bounded retries.  Deterministic data (``batch(step)``) makes the restart
  replay the same token stream.
* :class:`StragglerMonitor` — per-step deadline tracking against a running
  median; flags and (optionally) re-dispatches slow steps.

The driver waits for each step by reading its loss (``float(metrics[
"loss"])``, the port's ``jax.block_until_ready``).  A straggler re-dispatch
passes the state the step already returned back into ``step_fn``, which
applies that step's update a second time: the reference does the same
(``src/repro/runtime/driver.py:760-767``), and the port keeps it for parity
(ROADMAP queue 3).  The JAX module's ``ElasticPlanner`` waits for the
KV-slot slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from .faults import FaultInjector, as_injector


# --------------------------------------------------------------------------- #
# Straggler mitigation
# --------------------------------------------------------------------------- #
class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.times: list[float] = []
        self.window = window
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler (→ caller may re-dispatch)."""
        hist = self.times[-self.window:]
        self.times.append(dt)
        if len(hist) < 8:
            return False
        med = float(np.median(hist))
        if dt > self.threshold * med:
            self.flagged.append((step, dt))
            return True
        return False


# --------------------------------------------------------------------------- #
# Fault-tolerant training driver
# --------------------------------------------------------------------------- #
@dataclass
class TrainResult:
    steps_done: int
    final_loss: float
    restarts: int
    straggler_redispatches: int
    losses: list[float] = field(default_factory=list)


class FaultTolerantDriver:
    """Checkpoint/restart loop around ``step_fn(state, batch)``.

    ``step_fn`` returns (new_state, metrics-dict with "loss").
    ``faults`` is the fault-injection point: a
    :class:`~repro_torch.runtime.faults.FaultPlan` or built injector whose
    :meth:`~repro_torch.runtime.faults.FaultInjector.on_step` is called
    before each step.  ``fail_hook(step)`` (the legacy callback) is still
    accepted and wrapped via
    :meth:`~repro_torch.runtime.faults.FaultInjector.from_hook`.  Production
    leaves both None; real exceptions (a lost device, preemption) take the
    same recovery path.
    """

    def __init__(self, step_fn: Callable, store, data, *,
                 ckpt_every: int = 50, max_restarts: int = 3,
                 async_ckpt: bool = True,
                 straggler: StragglerMonitor | None = None,
                 redispatch_stragglers: bool = False,
                 faults: Any = None,
                 fail_hook: Callable[[int], None] | None = None):
        self.step_fn = step_fn
        self.store = store
        self.data = data
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.async_ckpt = async_ckpt
        self.straggler = straggler or StragglerMonitor()
        self.redispatch = redispatch_stragglers
        if faults is not None and fail_hook is not None:
            raise ValueError("pass faults= OR the legacy fail_hook=, not both")
        self._injector = (FaultInjector.from_hook(fail_hook)
                          if fail_hook is not None else as_injector(faults))

    def run(self, state: Any, n_steps: int) -> tuple[Any, TrainResult]:
        restarts = 0
        redispatches = 0
        # keyed by step so a restart that REPLAYS steps overwrites their
        # entries instead of appending duplicates
        losses: dict[int, float] = {}
        start = 0
        # resume from latest checkpoint if one exists
        latest = self.store.latest_step()
        if latest is not None:
            state, extra = self.store.restore(latest, like=state)
            start = int(extra.get("next_step", latest))

        step = start
        while step < n_steps:
            try:
                if self._injector is not None:
                    self._injector.on_step(step)
                batch = self.data.batch(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])        # waits for the step
                dt = time.perf_counter() - t0
                if self.straggler.record(step, dt) and self.redispatch:
                    # the reference re-dispatches with the updated state
                    state, metrics = self.step_fn(state, batch)
                    loss = float(metrics["loss"])
                    redispatches += 1
                losses[step] = loss
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    saver = (self.store.save_async if self.async_ckpt
                             else self.store.save)
                    saver(step, state, {"next_step": step})
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                latest = self.store.latest_step()
                if latest is None:
                    step = 0      # restart from scratch
                    continue
                self.store.wait()
                state, extra = self.store.restore(latest, like=state)
                step = int(extra.get("next_step", latest))
        self.store.wait()
        loss_seq = [losses[k] for k in sorted(losses)]
        return state, TrainResult(steps_done=step,
                                  final_loss=loss_seq[-1] if loss_seq
                                  else float("nan"),
                                  restarts=restarts,
                                  straggler_redispatches=redispatches,
                                  losses=loss_seq)
