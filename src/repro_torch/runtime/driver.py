"""Distributed runtime — fault tolerance, stragglers, elastic re-planning.

The port of the JAX package's ``runtime/driver.py``:

* :class:`FaultTolerantDriver` — checkpoint/restart training loop: periodic
  (async) checkpoints, automatic reload-and-continue on step failure with
  bounded retries.  Deterministic data (``batch(step)``) makes the restart
  replay the same token stream.
* :class:`StragglerMonitor` — per-step deadline tracking against a running
  median; flags and (optionally) re-dispatches slow steps.
* :class:`ElasticPlanner` — the Courier angle on elasticity: when the
  online profile contradicts the cost table a plan was balanced on, or the
  device set changes, *re-run the Pipeline Generator* on the measured costs
  (or the surviving devices) instead of serving on a stale plan.  It owns
  the serving-side executor: :meth:`ElasticPlanner.executor_for` rebuilds
  the :class:`~repro_torch.core.executor.PipelineExecutor` *only* when the
  stage boundaries (or replicas, pinnings, executor config) change, and
  every plan it builds shares one ``StageFn`` cache, so stages whose
  boundaries did not move are reused as they are.  The serving layer
  deploys a new executor with ``RequestQueueServer.swap_executor``.

The driver waits for each step by reading its loss (``float(metrics[
"loss"])``, the port's ``jax.block_until_ready``).  A straggler re-dispatch
passes the state the step already returned back into ``step_fn``, which
applies that step's update a second time: the reference does the same
(``src/repro/runtime/driver.py:760-767``), and the port keeps it for parity
(ROADMAP queue 3).

The planner keeps the JAX package's ``jit=`` keyword so call sites read
alike; the port's stages run eagerly, so it changes nothing and every
``StageFn.compiles`` stays 0.  Like every entry point of the port, the
planner runs on the card unless it is given ``device="cpu"``: its executors
run where the traced tensors live, which the planner checks against its
device, and pinned replicas on its inventory's devices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..core.ir import CourierIR
from ..core.partition import (PipelinePlan, StagePlan, assign_replicas,
                              partition_optimal)
from ..core.placement import (DeviceInventory, InventoryDiff, resolve_device,
                              resolve_worker_budget)
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
# Elastic re-planning (Courier re-balance on resource change OR profile drift)
# --------------------------------------------------------------------------- #
@dataclass
class ReplanDecision:
    """Outcome of one :meth:`ElasticPlanner.replan_from_profile` check."""

    replanned: bool
    reason: str
    old_bottleneck_ms: float          # measured bottleneck of the old plan
    new_bottleneck_ms: float          # predicted bottleneck of the new plan
    gain: float                       # old / new (1.0 when not replanned)
    defused: list[str] = field(default_factory=list)   # fused nodes split
    plan: Any = None                  # new PipelinePlan (None if unchanged)
    executor: Any = None              # new executor (None if unchanged)
    widened: bool = False             # won by replication, not re-balancing
    replicas: list[int] | None = None  # chosen per-stage worker counts

    def describe(self) -> str:
        verdict = "REPLAN" if self.replanned else "keep"
        return (f"[{verdict}] {self.reason}: measured bottleneck "
                f"{self.old_bottleneck_ms:.3f} ms -> predicted "
                f"{self.new_bottleneck_ms:.3f} ms ({self.gain:.2f}x)"
                + (f", replicas {self.replicas}" if self.widened else "")
                + (f", defused {self.defused}" if self.defused else ""))


def _check_traced_on(ir: CourierIR, device) -> None:
    """Raise unless every tensor the trace captured lies on ``device``'s
    type: the stage functions compute on those tensors where they are."""
    import torch

    elsewhere = sorted(f"{name} on {value.device}"
                       for name, value in ir.captured.items()
                       if isinstance(value, torch.Tensor)
                       and value.device.type != device.type)
    if elsewhere:
        raise ValueError(f"the planner runs on {device}, but the IR was "
                         f"traced with {', '.join(elsewhere)}")


class ElasticPlanner:
    """Re-balance pipeline stage boundaries when the stage count changes —
    or when the *online profile* contradicts the cost table the current
    plan was balanced on.

    ``db`` (optional) enables the executor path: the planner can then turn
    a re-balanced plan into stage functions and a running
    :class:`~repro_torch.core.executor.PipelineExecutor`, caching the
    current executor keyed by its stage boundaries.  A persistent
    ``StageFn`` cache (shared across every plan this planner builds) keeps
    the stages whose boundaries did not move.

    Re-plan policy knobs (hysteresis — no flapping under noisy timings):

    * ``min_gain`` — a new plan must beat the measured bottleneck by this
      factor before the executor is rebuilt (default 1.15);
    * ``margin`` — measured-vs-model contradiction factor that triggers a
      fuse/no-fuse revisit (default
      :data:`repro_torch.core.costmodel.PROFILE_MARGIN`);
    * ``min_samples`` — per-stage sample floor before the profile is
      trusted at all (also enforced by the profiler's window median, which
      is itself robust to stragglers).

    ``device`` is where the planner runs (the card unless ``"cpu"``); it
    raises without a card otherwise, like every entry point of the port.
    Its executors run where the IR's traced (captured) tensors live, so it
    also raises when any of them lies on another device type.
    """

    def __init__(self, layer_ir: CourierIR, db: Any = None, *,
                 min_gain: float = 1.15, margin: float | None = None,
                 min_samples: int = 4,
                 inventory: DeviceInventory | None = None,
                 fault_injector: Any = None, max_group_retries: int = 3,
                 quarantine_after: int = 1,
                 retry_budget_ms: float | None = None, device: Any = None):
        from ..core.costmodel import PROFILE_MARGIN

        self.device = resolve_device(device)
        _check_traced_on(layer_ir, self.device)
        self.layer_ir = layer_ir
        self.db = db
        # the devices the planner places stage replicas onto; None keeps
        # the host-thread widening (devices unpinned)
        self.inventory = inventory
        self.min_gain = float(min_gain)
        self.margin = PROFILE_MARGIN if margin is None else float(margin)
        self.min_samples = int(min_samples)
        # fault-tolerance knobs forwarded to every executor this planner
        # builds (constructor state, NOT cache-key material: swapping the
        # injector mid-run would otherwise force a spurious rebuild)
        self.fault_injector = as_injector(fault_injector)
        self.max_group_retries = int(max_group_retries)
        self.quarantine_after = int(quarantine_after)
        self.retry_budget_ms = (None if retry_budget_ms is None
                                else float(retry_budget_ms))
        self._cached: tuple[tuple, Any] | None = None
        self._current_plan: PipelinePlan | None = None
        self._stagefn_cache: dict = {}    # stage identity -> StageFn (reuse)
        # first-seen MODEL times per node, captured before any profile
        # write-back: the fusion-revisit contradiction check compares
        # measurements against the model, not against older measurements
        # (which would let gradual drift creep under the margin forever)
        self._model_ms: dict[str, float] = {}
        self.rebuilds = 0                 # executor rebuilds (observability)
        self.replans = 0                  # profile-driven plan changes
        self.replan_checks = 0            # replan_from_profile invocations
        self.last_decision: ReplanDecision | None = None

    def plan(self, n_stages: int) -> PipelinePlan:
        return partition_optimal(self.layer_ir, max_stages=n_stages)

    def boundaries(self, n_stages: int) -> list[int]:
        plan = self.plan(n_stages)
        bounds, i = [], 0
        for s in plan.stages:
            bounds.append(i)
            i += len(s.node_names)
        return bounds

    @property
    def current_plan(self) -> PipelinePlan | None:
        return self._current_plan

    def stagefns_cached(self) -> int:
        """Size of the cross-plan StageFn cache (observability)."""
        return len(self._stagefn_cache)

    @staticmethod
    def _cache_key(plan: PipelinePlan, replicas, max_in_flight, microbatch,
                   stage_workers, profiler, devices=None) -> tuple:
        """Executor-cache identity: plan shape + replicas + device pinning
        + executor config — the single source of truth for both
        :meth:`executor_for` and :meth:`replan_from_profile`.  ``jit`` is
        no part of it: it changes nothing about an eager executor."""
        return (tuple(len(s.node_names) for s in plan.stages),
                tuple(replicas) if replicas else None,
                tuple(tuple(row) for row in devices) if devices else None,
                max_in_flight, microbatch, stage_workers, id(profiler))

    def _build_executor(self, plan: PipelinePlan, *, max_in_flight, microbatch,
                        profiler=None, stage_workers=False,
                        replicas=None, devices=None) -> Any:
        from ..core.executor import PipelineExecutor
        from ..core.pipeline import assign_placements, make_stage_fns

        assign_placements(self.layer_ir, self.db)
        fns = make_stage_fns(self.layer_ir, self.db, plan,
                             cache=self._stagefn_cache)
        # captured graph inputs (traced closure weights) are bound by the
        # stage fns — the executor only sees the per-token inputs
        cap = getattr(self.layer_ir, "captured", {})
        token_inputs = [g for g in self.layer_ir.graph_inputs if g not in cap]
        return PipelineExecutor(fns, token_inputs,
                                self.layer_ir.graph_outputs,
                                max_in_flight=max_in_flight,
                                microbatch=microbatch, profiler=profiler,
                                stage_workers=stage_workers,
                                replicas=replicas, devices=devices,
                                inventory=self.inventory,
                                fault_injector=self.fault_injector,
                                max_group_retries=self.max_group_retries,
                                quarantine_after=self.quarantine_after,
                                retry_budget_ms=self.retry_budget_ms)

    def _widen(self, plan: PipelinePlan, worker_budget) -> tuple:
        """Run the widening pass on ``plan``; returns (replicas, devices)
        for the executor — (None, None) when no stage widened (or no
        budget resolved), so serial plans keep the async path with no stale
        pinnings (see :func:`~repro_torch.core.partition.
        widen_for_deployment`)."""
        from ..core.partition import widen_for_deployment

        return widen_for_deployment(plan, self.layer_ir,
                                    worker_budget=worker_budget,
                                    inventory=self.inventory)

    def executor_for(self, n_stages: int, *, max_in_flight: int | None = None,
                     microbatch: int = 1, jit: bool = True,
                     profiler: Any = None,
                     stage_workers: bool = False,
                     worker_budget: "int | str | None" = None,
                     ) -> tuple[Any, bool]:
        """(executor, rebuilt) for a resource count of ``n_stages``.

        Re-partitions the IR for the new stage count; when the resulting
        stage boundaries (or the requested executor config) differ from the
        cached executor's, a fresh executor is returned (``rebuilt=True``).
        An unchanged partition with the same config reuses the cached
        executor (``rebuilt=False``) — in-flight work survives the resize.

        ``worker_budget`` widens stages beyond one worker each
        (:func:`~repro_torch.core.partition.assign_replicas` over the
        planned stage times) and runs the executor in replicated mode: an
        int is the explicit budget, :data:`~repro_torch.core.placement.
        AUTO_BUDGET` derives it from the cpu-count governor, and ``None``
        widens only when the planner holds a :class:`~repro_torch.core.
        placement.DeviceInventory` (whose devices then pin the replicas).
        """
        if self.db is None:
            raise ValueError("ElasticPlanner needs a ModuleDatabase to build "
                             "executors; pass db= at construction")
        plan = self.plan(n_stages)
        replicas, devices = self._widen(plan, worker_budget)
        key = self._cache_key(plan, replicas, max_in_flight, microbatch,
                              stage_workers, profiler, devices)
        if self._cached is not None and self._cached[0] == key \
                and not getattr(self._cached[1], "closed", False):
            return self._cached[1], False
        ex = self._build_executor(plan, max_in_flight=max_in_flight,
                                  microbatch=microbatch, profiler=profiler,
                                  stage_workers=stage_workers,
                                  replicas=replicas, devices=devices)
        self._cached = (key, ex)
        self._current_plan = plan
        self.rebuilds += 1
        return ex, True

    def replan_from_profile(self, profiler: Any, *,
                            max_stages: int | None = None,
                            max_in_flight: int | None = None,
                            microbatch: int = 1, jit: bool = True,
                            stage_workers: bool = False,
                            min_gain: float | None = None,
                            margin: float | None = None,
                            min_samples: int | None = None,
                            revisit_fusion: bool = True,
                            worker_budget: "int | str | None" = None,
                            new_profiler: Any = None,
                            slo_violation_rate: float | None = None,
                            slo_replan_threshold: float = 0.05,
                            ) -> ReplanDecision:
        """Profile-guided re-plan check: measured costs -> maybe new executor.

        1. **Trust gate** — every current stage needs ``min_samples``
           measurements; otherwise keep the plan ("insufficient profile").
        2. **Write-back** — measured stage medians are attributed to nodes
           (:meth:`StageProfiler.apply_to_ir`), superseding roofline
           estimates (``time_source="profile"``).
        3. **Fusion revisit** — a fused node whose measured time
           contradicts its model by ``margin`` is split back into its
           parts (:func:`~repro_torch.core.partition.split_fused_node`) on
           a staged IR, committed only if the re-plan is accepted.
        4. **Re-balance** — ``partition_optimal`` over the measured costs
           (``max_stages`` defaults to the current stage count).  With a
           ``worker_budget``, a second candidate **widens** the current
           boundaries instead (the TBB parallel-filter move), the
           re-balanced candidate is widened too, and the plan whose
           effective (replication-aware) bottleneck is predicted smallest
           wins; ties go to widening (every StageFn is reused).
        5. **Hysteresis** — rebuild only when the predicted effective
           bottleneck beats the *measured* one by ``min_gain`` AND the plan
           (boundaries or replicas) changed.  A ``slo_violation_rate`` at
           or above ``slo_replan_threshold`` waives ``min_gain`` (treated
           as 1.0): deadlines are already being missed.

        A candidate that fails static verification is discarded and the
        current executor keeps serving.
        """
        from ..analysis.verify import PlanVerificationError, check_plan
        from ..core.costmodel import (measured_contradicts,
                                      replicated_bottleneck_ms)
        from ..core.partition import clear_stage_devices, split_fused_node

        if self.db is None:
            raise ValueError("ElasticPlanner needs a ModuleDatabase to build "
                             "executors; pass db= at construction")
        if self._current_plan is None:
            raise ValueError("no current plan: call executor_for() before "
                             "replan_from_profile()")
        min_gain = self.min_gain if min_gain is None else float(min_gain)
        slo_pressure = (slo_violation_rate is not None
                        and slo_violation_rate >= slo_replan_threshold)
        if slo_pressure:
            # deadlines are already being missed: any predicted gain
            # justifies a (zero-drop) swap, so hysteresis is waived
            min_gain = min(min_gain, 1.0)
        margin = self.margin if margin is None else float(margin)
        min_samples = self.min_samples if min_samples is None \
            else int(min_samples)
        self.replan_checks += 1
        plan = self._current_plan

        def keep(reason: str, old_b: float, new_b: float | None = None,
                 defused: list[str] | None = None) -> ReplanDecision:
            d = ReplanDecision(False, reason, old_b, new_b or old_b,
                               1.0 if not new_b else old_b / max(new_b, 1e-12),
                               defused or [])
            self.last_decision = d
            return d

        # 1) trust gate: the caller's (possibly lower) min_samples decides,
        #    so query the window directly rather than measured_ms (which
        #    enforces the profiler's own floor)
        if plan.n_stages > profiler.n_stages or \
                min(profiler.samples(k) for k in range(plan.n_stages)) \
                < min_samples:
            return keep("insufficient profile", 0.0)
        measured = [profiler.percentile_ms(k, 50.0)
                    for k in range(plan.n_stages)]
        if any(m is None for m in measured):
            return keep("insufficient profile", 0.0)
        # the profiler measures per-invocation SERVICE time; a stage already
        # replicated r-wide retires tokens at service/r
        old_bottleneck = replicated_bottleneck_ms(measured, plan.replicas)

        # 2) measured costs supersede the model (in place: time_ms only).
        #    Snapshot each node's model time FIRST — and only while it is
        #    still a model
        for n in self.layer_ir.nodes:
            if n.time_source != "profile" and n.time_ms is not None:
                self._model_ms.setdefault(n.name, n.time_ms)
        model_ms = {n.name: self._model_ms.get(n.name, n.time_ms)
                    for n in self.layer_ir.nodes}
        profiler.apply_to_ir(self.layer_ir, plan, min_samples=min_samples)

        # 3) fuse/no-fuse revisit under measured costs — STAGED on a local
        #    IR; a defuse on the keep path would orphan the current plan's
        #    fused stages
        ir = self.layer_ir
        defused: list[str] = []
        if revisit_fusion:
            for n in list(ir.nodes):
                if n.fused_from and measured_contradicts(
                        model_ms.get(n.name), n.time_ms, margin):
                    ir = split_fused_node(ir, n.name)
                    defused.append(n.name)

        # 4) re-balance on measured costs — and, under a worker budget, the
        #    competing widen-in-place candidate
        new_plan = partition_optimal(
            ir,
            max_stages=max_stages if max_stages is not None else plan.n_stages)
        chosen, widened = new_plan, False
        wb_new = resolve_worker_budget(worker_budget, new_plan.n_stages,
                                       self.inventory)
        if wb_new is not None:
            assign_replicas(new_plan, ir, worker_budget=wb_new,
                            inventory=self.inventory)
            widen = PipelinePlan(
                stages=[StagePlan(node_names=list(s.node_names),
                                  est_time_ms=float(m), kind=s.kind,
                                  placements=list(s.placements),
                                  comm_in_bytes=s.comm_in_bytes)
                        for s, m in zip(plan.stages, measured)],
                policy="widen")
            # widening never moves boundaries, so serial_only markers are
            # checked against the CURRENT (possibly still-fused) IR
            wb_widen = resolve_worker_budget(worker_budget, widen.n_stages,
                                             self.inventory)
            assign_replicas(widen, self.layer_ir, worker_budget=wb_widen,
                            inventory=self.inventory)
            if plan.stage_devices is not None:
                # the measured stage times already include the staging hop
                # and the device speed of the devices that ran them:
                # charging them again would bias the comparison
                for cand in (new_plan, widen):
                    for st in cand.stages:
                        st.xfer_in_ms = 0.0
                        st.device_speeds = []
            if widen.effective_bottleneck_ms \
                    <= new_plan.effective_bottleneck_ms * (1.0 + 1e-9):
                chosen, widened = widen, True

        # 5) hysteresis (plan identity = boundaries AND replicas)
        same_plan = (
            (widened or not defused)
            and [st.node_names for st in chosen.stages]
            == [st.node_names for st in plan.stages]
            and chosen.replicas == plan.replicas)
        if same_plan:
            return keep("plan unchanged", old_bottleneck)
        new_bottleneck = chosen.effective_bottleneck_ms
        gain = old_bottleneck / max(new_bottleneck, 1e-12)
        if gain < min_gain:
            return keep(f"gain {gain:.2f}x below hysteresis threshold "
                        f"{min_gain:.2f}x", old_bottleneck,
                        new_bottleneck, defused if not widened else [])

        # static legality gate: a failing candidate is DISCARDED — nothing
        # is committed (no IR, no plan, no cache entry).  Widening verifies
        # against the current (possibly fused) IR; a re-balance against
        # the staged (possibly defused) one.
        try:
            check_plan(self.layer_ir if widened else ir, chosen,
                       db=self.db, inventory=self.inventory,
                       where="ElasticPlanner.replan_from_profile")
        except PlanVerificationError as e:
            return keep(f"candidate failed verification ({', '.join(e.rules)})",
                        old_bottleneck, new_bottleneck)

        prof = new_profiler
        if prof is None and hasattr(profiler, "clone_for"):
            prof = profiler.clone_for(chosen.n_stages)
        if not widened:
            self.layer_ir = ir            # commit the (possibly defused) IR
        else:
            defused = []                  # widening kept the fused stages
        replicas = chosen.replicas if any(r > 1 for r in chosen.replicas) \
            else None
        if replicas is None:
            # deployed unpinned: the plan must not keep charging device
            # transfer costs the executor never pays
            clear_stage_devices(chosen)
        devices = chosen.stage_devices if replicas is not None else None
        ex = self._build_executor(plan=chosen, max_in_flight=max_in_flight,
                                  microbatch=microbatch, profiler=prof,
                                  stage_workers=stage_workers,
                                  replicas=replicas, devices=devices)
        key = self._cache_key(chosen, replicas, max_in_flight, microbatch,
                              stage_workers, prof, devices)
        self._cached = (key, ex)
        self._current_plan = chosen
        self.rebuilds += 1
        self.replans += 1
        reason = ("measured costs widened the bottleneck stage" if widened
                  else "measured costs re-balanced the plan")
        if slo_pressure:
            reason += (f" (SLO pressure: {slo_violation_rate:.1%} violation "
                       "rate waived hysteresis)")
        d = ReplanDecision(
            True, reason,
            old_bottleneck, new_bottleneck, gain,
            defused, chosen, ex, widened=widened,
            replicas=list(chosen.replicas))
        self.last_decision = d
        return d

    def autoscale_from_ladder(self, admission: Any, profiler: Any, *,
                              worker_budget: "int | str",
                              streak: int = 3,
                              **replan_kw: Any) -> ReplanDecision | None:
        """Capacity response to sustained overload: widen instead of shed.

        Watches the admission controller's ``level2_streak`` (consecutive
        observation windows whose worst level reached 2) and, once it
        reaches ``streak``, runs :meth:`replan_from_profile` with the given
        ``worker_budget`` — the widening candidate multiplies workers on
        the measured bottleneck stage.  Returns ``None`` below the trigger;
        otherwise the decision (deployed through
        ``RequestQueueServer.swap_executor`` when ``replanned``).  The
        streak is reset either way.
        """
        if int(streak) < 1:
            raise ValueError(f"streak must be >= 1 (got {streak})")
        if int(admission.level2_streak) < int(streak):
            return None
        decision = self.replan_from_profile(profiler,
                                            worker_budget=worker_budget,
                                            **replan_kw)
        admission.reset_streak()
        return decision

    def replan_on_inventory_change(self, diff: InventoryDiff, *,
                                   profiler: Any = None, stats: Any = None,
                                   max_in_flight: int | None = None,
                                   microbatch: int = 1, jit: bool = True,
                                   stage_workers: bool = False,
                                   worker_budget: "int | str | None" = None,
                                   new_profiler: Any = None) -> ReplanDecision:
        """Survivors-only re-plan after a device loss/gain.

        Takes the :class:`~repro_torch.core.placement.InventoryDiff` from
        ``DeviceInventory.refresh()`` and, when it reports a change:

        1. adopts ``diff.new`` as the planner's inventory (and renumbers
           the fault injector's device-keyed state along
           ``diff.survivors``);
        2. builds a **survivors candidate**: the current stage boundaries
           (every StageFn reused) re-widened onto the surviving devices,
           on measured stage medians when the profiler has them;
        3. **de-weights unhealthy survivors**: a surviving device whose
           error count (executor stats + profiler) or per-stage
           ``device_ms`` marks it slow has its speed scaled down;
        4. runs the candidate through the static verify gate — an illegal
           candidate keeps the current executor serving;
        5. builds the executor for the serving layer to deploy via
           ``swap_executor``.

        There is no hysteresis: a lost device is a hard fact.
        """
        from ..analysis.verify import PlanVerificationError, check_plan
        from ..core.costmodel import replicated_bottleneck_ms
        from ..core.partition import clear_stage_devices

        if self.db is None:
            raise ValueError("ElasticPlanner needs a ModuleDatabase to build "
                             "executors; pass db= at construction")
        if self._current_plan is None:
            raise ValueError("no current plan: call executor_for() before "
                             "replan_on_inventory_change()")
        self.replan_checks += 1
        plan = self._current_plan
        if not diff.changed:
            d = ReplanDecision(False, "inventory unchanged", 0.0, 0.0, 1.0)
            self.last_decision = d
            return d

        self.inventory = diff.new
        if self.fault_injector is not None:
            # scripted losses/counters are keyed by ordinal; follow the
            # survivors into the re-densified numbering
            self.fault_injector.remap_devices(diff.survivors)

        # stage times for the candidate: measured medians when the profile
        # has them (the loss usually happens mid-serve), model otherwise
        times = []
        for k, st in enumerate(plan.stages):
            m = None
            if profiler is not None and k < profiler.n_stages:
                m = profiler.percentile_ms(k, 50.0)
            times.append(float(m) if m is not None
                         else float(st.est_time_ms or 0.0))
        old_bottleneck = replicated_bottleneck_ms(times, plan.replicas)

        # unhealthy-survivor de-weighting: error counts and straggling
        # device_ms medians scale the surviving specs' speeds down
        errs: dict[int, int] = {}
        if stats is not None:
            for d_, c in (getattr(stats, "device_errors", None) or {}).items():
                errs[int(d_)] = errs.get(int(d_), 0) + int(c)
        slow: dict[int, float] = {}
        if profiler is not None:
            if hasattr(profiler, "device_errors"):
                for d_, c in profiler.device_errors().items():
                    errs[int(d_)] = errs.get(int(d_), 0) + int(c)
            for k in range(min(plan.n_stages, profiler.n_stages)):
                per_dev = profiler.device_ms(k)
                if len(per_dev) < 2:
                    continue
                med = float(np.median(list(per_dev.values())))
                for d_, ms in per_dev.items():
                    r = med / ms if ms > 0 else 1.0
                    slow[d_] = min(slow.get(d_, 1.0), min(r, 1.0))
        factors: dict[int, float] = {}
        for old, new in diff.survivors.items():
            f = slow.get(old, 1.0) / (1.0 + errs.get(old, 0))
            if f < 1.0:
                factors[new] = f
        inv = diff.new.reweighted(factors) if factors else diff.new

        cand = PipelinePlan(
            stages=[StagePlan(node_names=list(st.node_names),
                              est_time_ms=float(t), kind=st.kind,
                              placements=list(st.placements),
                              comm_in_bytes=st.comm_in_bytes)
                    for st, t in zip(plan.stages, times)],
            policy="survivors")
        wb = resolve_worker_budget(worker_budget, cand.n_stages, inv)
        assign_replicas(cand, self.layer_ir, worker_budget=wb, inventory=inv)

        try:
            check_plan(self.layer_ir, cand, db=self.db, inventory=inv,
                       where="ElasticPlanner.replan_on_inventory_change")
        except PlanVerificationError as e:
            d = ReplanDecision(
                False, "survivors candidate failed verification "
                f"({', '.join(e.rules)})", old_bottleneck, old_bottleneck,
                1.0)
            self.last_decision = d
            return d

        replicas = cand.replicas if any(r > 1 for r in cand.replicas) \
            else None
        if replicas is None:
            clear_stage_devices(cand)
        devices = cand.stage_devices if replicas is not None else None
        prof = new_profiler
        if prof is None and profiler is not None \
                and hasattr(profiler, "clone_for"):
            prof = profiler.clone_for(cand.n_stages)
        ex = self._build_executor(plan=cand, max_in_flight=max_in_flight,
                                  microbatch=microbatch, profiler=prof,
                                  stage_workers=stage_workers,
                                  replicas=replicas, devices=devices)
        key = self._cache_key(cand, replicas, max_in_flight, microbatch,
                              stage_workers, prof, devices)
        self._cached = (key, ex)
        self._current_plan = cand
        self.rebuilds += 1
        self.replans += 1
        d = ReplanDecision(
            True,
            f"inventory changed: lost {list(diff.lost)}, "
            f"gained {list(diff.gained)} -> re-widened onto "
            f"{len(diff.new)} survivors",
            old_bottleneck, cand.effective_bottleneck_ms,
            old_bottleneck / max(cand.effective_bottleneck_ms, 1e-12),
            plan=cand, executor=ex, widened=True,
            replicas=list(cand.replicas))
        self.last_decision = d
        return d


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
