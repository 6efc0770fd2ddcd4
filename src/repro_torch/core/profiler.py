"""Online stage profiler — the Frontend's runtime profile, kept live.

Courier-FPGA "gathers runtime information of library functions from a
running target binary" and feeds those *measured* times to the Pipeline
Generator.  The seed reproduction only did that once, at trace time; this
module keeps the measurement loop running while the pipeline serves
traffic, so the planner can re-balance when reality drifts from the model
(a stage slows down, a fused kernel underperforms its roofline, the host
gets noisy neighbors).

:class:`StageProfiler` is attached to a
:class:`~repro_torch.core.executor.PipelineExecutor` and fed per-stage wall times
from its issue/retire hooks:

* **threaded stage-worker mode** times every stage invocation exactly (each
  stage runs to completion inside its own worker);
* **async-dispatch mode** samples every ``sample_every``-th token group.  On
  the card a sampled group records a CUDA event before and after each of its
  stages on the stream they run on, and the executor reads the elapsed time
  when the group retires: the sample is the card's own time for the stage,
  and the host never waits for it.  On the CPU the stage has finished when
  its call returns, so the host clock around the call is the sample.

Per stage it maintains an **EMA** (fast trend signal) and a bounded
**percentile window** (robust location — the median is what re-planning
and the serving layer's admission control read, so a single straggler
sample cannot move them).

:meth:`StageProfiler.apply_to_ir` closes the loop: measured stage times are
written back into the IR's per-node ``time_ms`` (attributed proportionally
to the nodes' prior estimates), marked ``time_source="profile"`` so they
*supersede* roofline estimates everywhere downstream — the elastic
re-planner (:class:`~repro_torch.runtime.driver.ElasticPlanner`) balances
the next plan on them.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:                                    # pragma: no cover
    from typing import Sequence

    from .ir import CourierIR
    from .partition import PipelinePlan

__all__ = ["StageProfiler"]


class StageProfiler:
    """Low-overhead per-stage wall-time profile (EMA + percentile window).

    Parameters
    ----------
    n_stages:
        Number of pipeline stages to track.
    alpha:
        EMA smoothing factor (weight of the newest sample).
    window:
        Bounded sample window per stage; percentiles/medians are computed
        over it, so the memory cost is ``n_stages * window`` floats.
    sample_every:
        In async-dispatch mode, profile every ``sample_every``-th token
        group (1 = every group).  A sampled group costs two CUDA events a
        stage on the card (no host wait); the default keeps sampling sparse
        (1 in 8).  Threaded stage workers ignore this — their timing is
        free.
    min_samples:
        Minimum per-stage samples before :meth:`measured_ms` (and hence
        re-planning) trusts the window.
    """

    def __init__(self, n_stages: int, *, alpha: float = 0.25,
                 window: int = 64, sample_every: int = 8,
                 min_samples: int = 4):
        if n_stages < 1:
            raise ValueError(f"n_stages must be >= 1 (got {n_stages})")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1] (got {alpha})")
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1 (got {sample_every})")
        self.n_stages = n_stages
        self.alpha = float(alpha)
        self.window = int(window)
        self.sample_every = int(sample_every)
        self.min_samples = int(min_samples)
        self._ema: list[float | None] = [None] * n_stages
        self._win: list[deque] = [deque(maxlen=window) for _ in range(n_stages)]
        self._count = [0] * n_stages
        self._ticks = 0
        self._lock = threading.Lock()
        # per-(stage, replica) attribution for replicated stages:
        # (stage, replica) -> [count, ema]; populated only when the
        # executor reports a replica index
        self._replica: dict[tuple[int, int], list] = {}
        # per-(stage, device-ordinal) attribution for device-pinned
        # replicas: (stage, device) -> [count, ema]; populated only when
        # the executor reports a device ordinal, so snapshots show which
        # chip served the stage (and which chip is the straggler)
        self._device: dict[tuple[int, int], list] = {}
        # stage-call failures, attributed like the timings: the elastic
        # replanner reads these (with device_ms) to de-weight an unhealthy
        # device instead of re-widening onto it
        self._errors: list[int] = [0] * n_stages
        self._device_errors: dict[int, int] = {}
        # seam occupancy (continuous batching): EMA of the fill fraction
        # each group sealed with (real seats / total rows) plus a seal
        # count — low fill = admission leaves seats on the table
        self._seam_fill: float | None = None
        self._seam_seals = 0

    def clone_for(self, n_stages: int) -> "StageProfiler":
        """Fresh profiler with the same knobs for a re-planned stage count."""
        return StageProfiler(n_stages, alpha=self.alpha, window=self.window,
                             sample_every=self.sample_every,
                             min_samples=self.min_samples)

    # -- executor-side hooks -------------------------------------------------- #
    def tick(self) -> bool:
        """Admission-side sampling gate: True every ``sample_every``-th call."""
        with self._lock:
            t = self._ticks
            self._ticks += 1
        return t % self.sample_every == 0

    def record(self, stage: int, ms: float, replica: int | None = None,
               device: int | None = None) -> None:
        """Record one measured wall time (ms) for ``stage``.

        ``replica`` (replicated-stage executors) additionally attributes
        the sample to that worker, so a straggling replica — one slow
        thread among N serving a widened stage — is visible in
        :meth:`snapshot` instead of being averaged away; ``device``
        (device-pinned replicas) attributes it to the chip/core that ran
        it, so per-device service times land in the same snapshot.  The
        per-stage aggregate (what re-planning reads) always measures the
        *service* time of one token group, whichever replica ran it.
        """
        if not 0 <= stage < self.n_stages:
            raise IndexError(f"stage {stage} out of range [0, {self.n_stages})")
        ms = float(ms)
        with self._lock:
            prev = self._ema[stage]
            self._ema[stage] = ms if prev is None \
                else (1.0 - self.alpha) * prev + self.alpha * ms
            self._win[stage].append(ms)
            self._count[stage] += 1
            for table, idx in ((self._replica, replica),
                               (self._device, device)):
                if idx is None:
                    continue
                rec = table.setdefault((stage, int(idx)), [0, None])
                rec[0] += 1
                rec[1] = ms if rec[1] is None \
                    else (1.0 - self.alpha) * rec[1] + self.alpha * ms

    def record_seam(self, filled: int, capacity: int) -> None:
        """Record one sealed group's seam occupancy (continuous batching):
        ``filled`` real seats out of ``capacity`` stacked rows."""
        if capacity <= 0:
            return
        frac = min(max(filled / capacity, 0.0), 1.0)
        with self._lock:
            self._seam_fill = frac if self._seam_fill is None \
                else (1.0 - self.alpha) * self._seam_fill + self.alpha * frac
            self._seam_seals += 1

    def seam_fill(self) -> float | None:
        """EMA seam fill fraction (None before any group sealed)."""
        with self._lock:
            return self._seam_fill

    def record_error(self, stage: int, replica: int | None = None,
                     device: int | None = None) -> None:
        """Record one failed stage call (the timing never lands — the call
        raised — so errors are counted separately from the samples)."""
        if not 0 <= stage < self.n_stages:
            raise IndexError(f"stage {stage} out of range [0, {self.n_stages})")
        del replica  # reserved for symmetry with record(); not tabulated yet
        with self._lock:
            self._errors[stage] += 1
            if device is not None:
                d = int(device)
                self._device_errors[d] = self._device_errors.get(d, 0) + 1

    # -- queries --------------------------------------------------------------- #
    def samples(self, stage: int) -> int:
        with self._lock:
            return self._count[stage]

    def ema_ms(self, stage: int) -> float | None:
        with self._lock:
            return self._ema[stage]

    def percentile_ms(self, stage: int, q: float = 50.0) -> float | None:
        with self._lock:
            win = list(self._win[stage])
        if not win:
            return None
        return float(np.percentile(np.asarray(win, dtype=np.float64), q))

    def measured_ms(self, stage: int) -> float | None:
        """Robust per-stage location: the window median, once ``min_samples``
        samples exist.  Medians (not EMAs) drive re-planning so one
        straggler sample cannot flip a plan."""
        if self.samples(stage) < self.min_samples:
            return None
        return self.percentile_ms(stage, 50.0)

    def replica_ms(self, stage: int) -> dict[int, float]:
        """Per-replica EMA wall times for one stage (replicated executors).

        Empty for stages that never reported a replica index.  This is
        *service* time per replica — the planner divides the stage median
        by the replica count for throughput, but a per-replica spread here
        flags a straggling worker thread.
        """
        with self._lock:
            return {w: rec[1] for (s, w), rec in self._replica.items()
                    if s == stage and rec[1] is not None}

    def device_ms(self, stage: int) -> dict[int, float]:
        """Per-device EMA wall times for one stage (device-pinned replicas).

        Empty for stages whose samples never carried a device ordinal.
        Heterogeneous entries here mean the widened stage's chips are not
        pulling equally — the device-level analog of :meth:`replica_ms`.
        """
        with self._lock:
            return {d: rec[1] for (s, d), rec in self._device.items()
                    if s == stage and rec[1] is not None}

    def error_count(self, stage: int) -> int:
        with self._lock:
            return self._errors[stage]

    def device_errors(self) -> dict[int, int]:
        """Failed stage calls per device ordinal (all stages pooled) —
        the error half of the replanner's unhealthy-device signal."""
        with self._lock:
            return dict(self._device_errors)

    @property
    def ready(self) -> bool:
        """True once every stage has ``min_samples`` measurements."""
        return all(self._count[k] >= self.min_samples
                   for k in range(self.n_stages))

    def effective_period_ms(self, replicas: "Sequence[int] | None" = None,
                            ) -> float | None:
        """Measured steady-state token period of the running pipeline.

        The replication-aware bottleneck
        (:func:`~repro_torch.core.costmodel.replicated_bottleneck_ms`) over the
        per-stage window **medians** — the measured analog of
        ``plan.effective_bottleneck_ms``, and the service-period input to
        the serving layer's admission controller (predicted queue wait =
        dispatch groups ahead x this period).  ``None`` until every stage
        has ``min_samples`` measurements, so admission keeps using the
        plan's model until the profile can stand on its own.
        """
        from .costmodel import replicated_bottleneck_ms

        meds = [self.measured_ms(k) for k in range(self.n_stages)]
        if any(m is None for m in meds):
            return None
        reps = list(replicas) if replicas is not None else [1] * self.n_stages
        if len(reps) != self.n_stages:
            return None
        return replicated_bottleneck_ms(meds, reps)

    def snapshot(self) -> dict:
        """Machine-readable per-stage profile (for stats endpoints)."""
        stages = []
        for k in range(self.n_stages):
            entry = {
                "samples": self.samples(k),
                "ema_ms": _round(self.ema_ms(k)),
                "p50_ms": _round(self.percentile_ms(k, 50.0)),
                "p90_ms": _round(self.percentile_ms(k, 90.0)),
            }
            with self._lock:
                reps = {str(w): {"samples": rec[0], "ema_ms": _round(rec[1])}
                        for (s, w), rec in sorted(self._replica.items())
                        if s == k}
                devs = {str(d): {"samples": rec[0], "ema_ms": _round(rec[1])}
                        for (s, d), rec in sorted(self._device.items())
                        if s == k}
            if reps:
                entry["replicas"] = reps
            if devs:
                entry["devices"] = devs
            if self.error_count(k):
                entry["errors"] = self.error_count(k)
            stages.append(entry)
        out = {"n_stages": self.n_stages, "sample_every": self.sample_every,
               "window": self.window, "per_stage": stages}
        with self._lock:
            if self._seam_seals:
                out["seam"] = {"fill_ema": _round(self._seam_fill),
                               "seals": self._seam_seals}
        return out

    def reset(self) -> None:
        with self._lock:
            self._ema = [None] * self.n_stages
            self._win = [deque(maxlen=self.window)
                         for _ in range(self.n_stages)]
            self._count = [0] * self.n_stages
            self._ticks = 0
            self._replica.clear()
            self._device.clear()
            self._errors = [0] * self.n_stages
            self._device_errors.clear()
            self._seam_fill = None
            self._seam_seals = 0

    # -- cost-model write-back -------------------------------------------------- #
    def apply_to_ir(self, ir: "CourierIR", plan: "PipelinePlan", *,
                    min_samples: int | None = None) -> dict[str, float]:
        """Write measured stage times back into the IR as per-node costs.

        For every stage with a trusted measurement, the stage's median time
        is attributed to its nodes proportionally to their *prior*
        ``time_ms`` (uniformly when no priors exist), and each updated node
        is marked ``time_source="profile"`` so downstream estimators never
        overwrite the measurement with a model.  Returns ``{node_name:
        previous time_ms}`` for every node updated (the planner uses it to
        detect measured-vs-model contradictions).
        """
        need = self.min_samples if min_samples is None else min_samples
        replaced: dict[str, float] = {}
        for k, s in enumerate(plan.stages):
            if k >= self.n_stages or self.samples(k) < need:
                continue
            m = self.percentile_ms(k, 50.0)
            if m is None:
                continue
            nodes = [ir.node(nn) for nn in s.node_names]
            priors = [n.time_ms for n in nodes]
            # proportional attribution needs a full, positive prior vector;
            # otherwise fall back to uniform — attributing 0 ms to a
            # None-prior node would pin it as a "measured" free node that
            # no estimator may ever correct
            total = sum(p for p in priors if p is not None)
            proportional = all(p is not None for p in priors) and total > 0
            for n, prior in zip(nodes, priors):
                share = (prior / total) if proportional else 1.0 / len(nodes)
                replaced[n.name] = prior if prior is not None else 0.0
                n.time_ms = m * share
                n.time_source = "profile"
        return replaced


def _round(x: float | None, nd: int = 4) -> float | None:
    return None if x is None else round(float(x), nd)
