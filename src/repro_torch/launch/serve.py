"""Serving launcher — the LM decode loop and the request-queue server over a
Courier-built pipeline.

Three serving modes, on the card unless the caller asks for the CPU with
``--device cpu``:

* ``lm`` (default) — batched prefill into a KV cache, then greedy decode, on
  the LM stack, any family (:func:`serve_lm`); every prefill self- and
  cross-attention runs the flash-attention kernel (K7), the hybrid and
  rwkv blocks carry their recurrent state in the cache, and the vlm
  family's cache holds the image K/V its decode steps reuse::

      python -m repro_torch.launch.serve --mode lm --arch gemma3-12b \\
          --no-reduced --layers 6 --batch 4 --prompt-len 4096 --tokens 32
      python -m repro_torch.launch.serve --mode lm --arch rwkv6-1.6b \\
          --no-reduced --batch 4 --prompt-len 4096 --tokens 32
      python -m repro_torch.launch.serve --mode lm \\
          --arch llama-3.2-vision-11b --no-reduced --prompt-len 4096

* ``trace`` and ``pipeline`` — a request-queue serving loop over a token
  pipeline (the ROADMAP's "serve heavy traffic" front-end)::

      python -m repro_torch.launch.serve --mode trace     # traced transformer
      python -m repro_torch.launch.serve --mode pipeline  # Harris pipeline

:class:`RequestQueueServer` accepts requests into per-priority-class queues
(interactive / batch / best-effort), forms dynamic batches (up to
``max_batch``, waiting at most ``max_wait_ms`` after the first request of a
batch), and feeds them to a :class:`~repro_torch.core.executor.
PipelineExecutor`.  Backpressure comes from the executor's bounded token
pool: the batcher blocks inside ``submit_many`` while the pool is full,
which in turn fills the bounded request queue and blocks producers — unless
an :class:`AdmissionController` is attached, in which case load the queue
cannot absorb is *shed* (fast-failed with :class:`Overloaded`) instead of
blocking submitters, and a degradation ladder sheds best-effort traffic
first.  Per-request latency (queue + execute) is recorded and summarized
per class by :meth:`RequestQueueServer.stats`.

Overload-protection model:

* **Priority classes** — ``submit(..., priority=)`` with strict priority
  across classes and earliest-deadline-first order within a class; a
  starvation-avoidance credit guarantees a lower class the next batch after
  it has been passed over ``starvation_credit`` times.
* **Admission control** — the controller predicts the queue wait a new
  request would see (dispatch-group period x groups ahead of it) and
  sheds, at submit time, requests that cannot meet their deadline.
* **Graceful degradation** — a pressure ladder derived from the predicted
  backlog: level 1 sheds best-effort, level 2 additionally shrinks the
  batcher's max-wait.
* **End-to-end deadlines** — a request past its deadline is failed with
  :class:`DeadlineExceeded` wherever it is caught: at submit (predicted),
  at dispatch (still queued), or at retirement — never returned late.
* **Continuous batching** (``continuous=True``) — requests join in-flight
  groups at the executor's seam instead of waiting out a batching window;
  ``Request.on_finish`` returns per-request state (a KV slot) on every
  terminal path.
* **Hot swap** — :meth:`RequestQueueServer.swap_executor` installs the
  executor an elastic re-plan built at a batch boundary, while the batches
  already issued drain on the old one.

Unlike the JAX package's CLI, ``--reduced`` can be turned off
(``--no-reduced``), so the LM mode runs at an architecture's full widths;
``--layers N`` cuts depth only.
"""
from __future__ import annotations

import argparse
import dataclasses
import heapq
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.executor import ExecutorClosed, PipelineExecutor

# priority classes: strict priority in ascending order (0 preempts 1
# preempts 2); PRIORITY_CLASSES names them for stats/benchmark reporting
INTERACTIVE, BATCH, BEST_EFFORT = 0, 1, 2
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
N_CLASSES = len(PRIORITY_CLASSES)


def priority_of(p: "int | str") -> int:
    """Normalize a priority argument (class index or class name)."""
    if isinstance(p, str):
        try:
            return PRIORITY_CLASSES.index(p.replace("-", "_"))
        except ValueError:
            raise ValueError(f"unknown priority class {p!r}; expected one "
                             f"of {PRIORITY_CLASSES}") from None
    i = int(p)
    if not 0 <= i < N_CLASSES:
        raise ValueError(f"priority must be in [0, {N_CLASSES}) (got {i})")
    return i


class DeadlineExceeded(TimeoutError):
    """A request's ``deadline_ms`` expired before its result could be
    delivered — late work is degraded (failed fast) instead of returned
    late, whether it was still queued or already in flight."""


class WaitTimeout(TimeoutError):
    """:meth:`Request.wait`'s own ``timeout=`` expired before the request
    resolved.  Distinct from :class:`DeadlineExceeded` (the *request's*
    deadline, raised from ``Request.error``) so callers can tell "my wait
    gave up" from "the server failed the request"."""


class Overloaded(RuntimeError):
    """Request shed at submit time by the :class:`AdmissionController`:
    the predicted queue wait exceeds its deadline, the degradation ladder
    is shedding its class, or the bounded queue is full.  Fast-fail —
    the request never consumed queue or executor capacity."""


# --------------------------------------------------------------------------- #
# Request-queue serving loop over a token-pipeline executor
# --------------------------------------------------------------------------- #
@dataclass
class Request:
    """One in-flight serving request with its latency timeline."""

    args: tuple
    t_submit: float
    t_batch: float | None = None      # when the batcher picked it up
    t_done: float | None = None       # when its outputs were ready
    result: Any = None
    error: BaseException | None = None
    deadline_ms: float | None = None  # end-to-end deadline (degrade if past)
    priority: int = INTERACTIVE      # class index into PRIORITY_CLASSES
    # release hook: called exactly once with the request AFTER it resolved
    # (every terminal outcome — served/shed/expired/failed), outside the
    # server lock.  This is where per-request resources pinned at submit
    # time (a KV-cache slot) are returned: a shed or expired request must
    # free its slot exactly like a served one, or the arena leaks.
    on_finish: Any = None
    _event: threading.Event = field(default_factory=threading.Event)
    _finished: bool = False           # owner: RequestQueueServer._lock

    def wait(self, timeout: float | None = None) -> Any:
        """Block for the result.  Raises :class:`WaitTimeout` when
        ``timeout`` expires first (the request may still resolve later —
        a later ``wait`` observes it), and re-raises the request's own
        error (:class:`DeadlineExceeded`, :class:`Overloaded`, executor
        failures) once it resolved unsuccessfully."""
        if not self._event.wait(timeout):
            raise WaitTimeout(
                f"request not served within wait timeout ({timeout} s)")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def deadline_at(self) -> float:
        """Absolute deadline on the ``perf_counter`` clock (inf if none) —
        the EDF ordering key within a priority class."""
        if self.deadline_ms is None:
            return math.inf
        return self.t_submit + self.deadline_ms / 1e3

    @property
    def latency_ms(self) -> float | None:
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    @property
    def queue_ms(self) -> float | None:
        if self.t_batch is None:
            return None
        return (self.t_batch - self.t_submit) * 1e3


def replication_aware_batching(plan: Any, *, max_batch: int,
                               max_wait_ms: float,
                               max_growth: float = 4.0,
                               min_wait_ms: float = 0.25,
                               ) -> tuple[int, float]:
    """Derive dynamic-batching knobs from the plan's *effective* period.

    A widened stage drains token groups ``r``-wide, so the pipeline's
    steady-state token period is the plan's effective (replication-aware)
    bottleneck, not the serial one.  Holding the batcher at knobs tuned
    for the serial period would starve the replicas: the max-wait deadline
    admits one batch per serial period while the executor could retire
    ``ratio = serial / effective`` of them.  This helper scales the knobs
    by that ratio — ``max_batch`` grows (more tokens per admission keeps
    every replica fed) and ``max_wait_ms`` shrinks (partial batches
    dispatch sooner because the pipeline drains faster) — clamped to
    ``max_growth`` so a massively widened plan doesn't balloon the
    compiled batch shape, and to ``min_wait_ms`` so the batcher never
    busy-spins.  A serial plan (ratio 1) returns the knobs unchanged.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    serial = float(plan.bottleneck_ms)
    eff = float(plan.effective_bottleneck_ms)
    if serial <= 0.0 or eff <= 0.0:
        return max_batch, max_wait_ms
    ratio = min(max(serial / eff, 1.0), float(max_growth))
    return (max(1, int(round(max_batch * ratio))),
            max(max_wait_ms / ratio, min_wait_ms))


def _percentile(xs: list, q: float) -> float:
    """Exact linear-interpolation percentile over finite samples only;
    0.0 for empty windows.

    Latency windows can be tiny (a 1-request batch right after startup) or
    carry non-finite entries (a timed-out clock pair); filtering here keeps
    the stats endpoint NaN-free instead of poisoning dashboards.  Linear
    interpolation (the numpy default, implemented explicitly here) makes
    tail quantiles — p99/p999 over modest windows — exact instead of
    snapping to the nearest sample rank.
    """
    vals = sorted(float(x) for x in xs
                  if x is not None and math.isfinite(float(x)))
    if not vals:
        return 0.0
    q = min(max(float(q), 0.0), 100.0)
    rank = (q / 100.0) * (len(vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def _latency_summary(lat: list) -> dict:
    return {
        "mean": float(np.mean(lat)) if lat else 0.0,
        "p50": _percentile(lat, 50),
        "p95": _percentile(lat, 95),
        "p99": _percentile(lat, 99),
        "p999": _percentile(lat, 99.9),
        "max": max(lat) if lat else 0.0,
    }


# --------------------------------------------------------------------------- #
# Admission control + degradation ladder
# --------------------------------------------------------------------------- #
class AdmissionController:
    """Submit-time admission control with a degradation ladder.

    The controller predicts the queueing delay a new request would see —
    ``ceil(depth_ahead / batch_hint) * period_ms``, where ``period_ms`` is
    the service period of one dispatch group (the pipeline's effective,
    replication-aware bottleneck) and ``depth_ahead`` counts the queued
    requests at its priority or higher plus the executor's in-flight
    tokens — and **sheds** (fast-fails with :class:`Overloaded`) requests
    that cannot meet their deadline *at submit time*, before they consume
    queue or token-pool capacity.

    A **degradation ladder** derived from the total predicted backlog
    (all classes) relative to ``slo_ref_ms`` degrades service under
    sustained pressure instead of collapsing:

    * level 0 — backlog <= ``shed_at`` x ref: admit everything;
    * level 1 — backlog > ``shed_at`` x ref: shed best-effort;
    * level 2 — backlog > ``degrade_at`` x ref: shed best-effort AND
      report ``max_wait_scale() < 1`` so the batcher dispatches partial
      batches sooner (latency over batching efficiency).

    ``period_ms`` starts from the plan's model (or a calibration run) and
    is refreshed from the online profile via :meth:`update_period`, so the
    admission rule tracks the pipeline the executor actually runs, not the
    one the planner predicted.
    """

    def __init__(self, period_ms: float, *, batch_hint: int = 1,
                 slo_ref_ms: float | None = None, shed_at: float = 0.5,
                 degrade_at: float = 1.0, degraded_wait_scale: float = 0.5,
                 deadline_slack: float = 1.0, ref_periods: float = 20.0):
        if period_ms <= 0.0:
            raise ValueError(f"period_ms must be > 0 (got {period_ms})")
        if batch_hint < 1:
            raise ValueError(f"batch_hint must be >= 1 (got {batch_hint})")
        if not 0.0 < shed_at <= degrade_at:
            raise ValueError(f"need 0 < shed_at <= degrade_at "
                             f"(got {shed_at}, {degrade_at})")
        if not 0.0 < degraded_wait_scale <= 1.0:
            raise ValueError(f"degraded_wait_scale must be in (0, 1] "
                             f"(got {degraded_wait_scale})")
        self.period_ms = float(period_ms)    # owner: updater (single writer)
        self.batch_hint = int(batch_hint)
        self.slo_ref_ms = None if slo_ref_ms is None else float(slo_ref_ms)
        self.shed_at = float(shed_at)
        self.degrade_at = float(degrade_at)
        self.degraded_wait_scale = float(degraded_wait_scale)
        self.deadline_slack = float(deadline_slack)
        self.ref_periods = float(ref_periods)
        self._lock = threading.Lock()
        self._level = 0
        self._window_max_level = 0       # worst level seen this window
        self._streak = 0                 # consecutive level-2 windows
        self.admitted = [0] * N_CLASSES
        self.shed = [0] * N_CLASSES
        self.shed_reasons = {"deadline": 0, "ladder": 0, "queue_full": 0}

    @classmethod
    def from_plan(cls, plan: Any, *, max_batch: int = 1,
                  **kwargs: Any) -> "AdmissionController":
        """Seed the period from the plan's effective (replication-aware)
        bottleneck; the online profile refines it once traffic flows."""
        return cls(max(float(plan.effective_bottleneck_ms), 1e-3),
                   batch_hint=max_batch, **kwargs)

    # -- model ---------------------------------------------------------------- #
    def update_period(self, period_ms: float) -> None:
        """Refresh the dispatch-group period from the online profile."""
        if period_ms and period_ms > 0.0:
            self.period_ms = float(period_ms)

    def predicted_wait_ms(self, depth_ahead: int) -> float:
        """Queue-wait prediction for a request with ``depth_ahead``
        requests (queued at >= its priority, plus in-flight) before it:
        full dispatch groups x the per-group service period."""
        groups = math.ceil(max(int(depth_ahead), 0) / self.batch_hint)
        return groups * self.period_ms

    def _ref_ms(self) -> float:
        return self.slo_ref_ms if self.slo_ref_ms is not None \
            else self.ref_periods * self.period_ms

    def level(self, depth_total: int) -> int:
        """Degradation-ladder level for the current total backlog."""
        backlog = self.predicted_wait_ms(depth_total)
        ref = self._ref_ms()
        if backlog > self.degrade_at * ref:
            return 2
        if backlog > self.shed_at * ref:
            return 1
        return 0

    def max_wait_scale(self) -> float:
        """Batcher max-wait multiplier for the last observed level."""
        return self.degraded_wait_scale if self._level >= 2 else 1.0

    def end_window(self) -> None:
        """Close one observation window of the sustained-pressure signal.

        A window whose *worst* admission-time ladder level reached 2
        extends the level-2 streak; anything milder resets it.  The
        batcher closes a window alongside every admission-period refresh,
        so the streak counts consecutive dispatch windows spent at the top
        of the ladder (the signal an autoscaler would watch).
        """
        with self._lock:
            if self._window_max_level >= 2:
                self._streak += 1
            else:
                self._streak = 0
            self._window_max_level = 0

    @property
    def level2_streak(self) -> int:
        """Consecutive closed windows whose worst level reached 2."""
        with self._lock:
            return self._streak

    def reset_streak(self) -> None:
        """Restart the sustained-pressure observation window — for an
        autoscaler that acted on a streak, so one burst triggers one widen
        attempt rather than one per subsequent window."""
        with self._lock:
            self._streak = 0
            self._window_max_level = 0

    # -- the admission rule ---------------------------------------------------- #
    def admit(self, *, priority: int, deadline_ms: float | None,
              depth_ahead: int, depth_total: int) -> str | None:
        """``None`` to admit, else the shed reason.

        Ladder first (pressure sheds whole classes regardless of their
        deadlines), then the per-request deadline feasibility check.
        """
        level = self.level(depth_total)
        with self._lock:
            self._level = level
            if level > self._window_max_level:
                self._window_max_level = level
            if level >= 1 and priority >= BEST_EFFORT:
                self.shed[priority] += 1
                self.shed_reasons["ladder"] += 1
                return (f"degradation ladder level {level}: shedding "
                        f"{PRIORITY_CLASSES[priority]} traffic")
            if deadline_ms is not None:
                wait = self.predicted_wait_ms(depth_ahead)
                if wait > float(deadline_ms) * self.deadline_slack:
                    self.shed[priority] += 1
                    self.shed_reasons["deadline"] += 1
                    return (f"predicted queue wait {wait:.1f} ms exceeds "
                            f"the {deadline_ms:g} ms deadline "
                            f"({depth_ahead} ahead, period "
                            f"{self.period_ms:.2f} ms)")
            self.admitted[priority] += 1
            return None

    def note_queue_full(self, priority: int) -> None:
        """Account a shed caused by the bounded queue refusing the put."""
        with self._lock:
            # the request was counted admitted by admit(); it ended up
            # shed after all, so move it across
            self.admitted[priority] = max(self.admitted[priority] - 1, 0)
            self.shed[priority] += 1
            self.shed_reasons["queue_full"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "period_ms": round(self.period_ms, 4),
                "batch_hint": self.batch_hint,
                "slo_ref_ms": round(self._ref_ms(), 4),
                "level": self._level,
                "level2_streak": self._streak,
                "admitted": {PRIORITY_CLASSES[c]: self.admitted[c]
                             for c in range(N_CLASSES)},
                "shed": {PRIORITY_CLASSES[c]: self.shed[c]
                         for c in range(N_CLASSES)},
                "shed_reasons": dict(self.shed_reasons),
            }


# --------------------------------------------------------------------------- #
# Per-class EDF queues (one condition: put/get/stop all share it)
# --------------------------------------------------------------------------- #
class _ClassedQueue:
    """Bounded per-priority-class request queues under one condition.

    Within a class, requests pop earliest-deadline-first (deadline-less
    requests order FIFO after every deadlined one); across classes the
    batcher takes the highest-priority non-empty class, except that a
    class passed over ``credit`` times in a row gets the next batch — the
    starvation-avoidance credit that keeps batch/best-effort draining
    under sustained interactive load.

    One :class:`threading.Condition` serializes everything and doubles as
    the batcher's wakeup: ``put`` notifies on enqueue, :meth:`wake` is the
    stop signal — the batcher never polls, and an idle server stops
    promptly.
    """

    def __init__(self, maxsize: int, *, credit: int = 4):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1 (got {maxsize})")
        if credit < 1:
            raise ValueError(f"credit must be >= 1 (got {credit})")
        self.maxsize = int(maxsize)
        self.credit = int(credit)
        self._cond = threading.Condition(threading.Lock())
        self._heaps: list[list] = [[] for _ in range(N_CLASSES)]
        self._skipped = [0] * N_CLASSES
        self._size = 0
        self._seq = 0
        self._closed = False

    # -- producer side --------------------------------------------------------- #
    def put(self, r: Request, *, block: bool = True) -> str:
        """Enqueue; returns ``"ok"``, ``"full"`` (non-blocking refusal),
        or ``"closed"`` (the server stopped — callers must fail the
        request, never leave it parked)."""
        with self._cond:
            while True:
                if self._closed:
                    return "closed"
                if self._size < self.maxsize:
                    heapq.heappush(self._heaps[r.priority],
                                   (r.deadline_at, self._seq, r))
                    self._seq += 1
                    self._size += 1
                    self._cond.notify_all()
                    return "ok"
                if not block:
                    return "full"
                self._cond.wait()

    # -- consumer side (batcher thread only) ----------------------------------- #
    def _select_class(self) -> tuple[int, bool] | None:
        """(class, credit_override) for the next batch, or ``None``.

        ``credit_override`` is True when the starvation credit forced a
        lower class *past* a non-empty higher one — the batcher then
        dispatches a single-request trickle batch, so the credit costs
        the higher class one service period per ``credit`` batches
        instead of a full ``max_batch`` flush (which would invert the
        priority under sustained load).  Must hold the condition."""
        nonempty = [c for c in range(N_CLASSES) if self._heaps[c]]
        if not nonempty:
            return None
        starved = [c for c in nonempty if self._skipped[c] >= self.credit]
        pick = min(starved) if starved else min(nonempty)
        for c in nonempty:
            if c > pick:
                self._skipped[c] += 1
        self._skipped[pick] = 0
        return pick, pick != min(nonempty)

    def get_first(self, abort: Any) -> tuple[Request | None, bool]:
        """Block for the first request of the next batch.

        Returns ``(request, credit_override)``; request is ``None`` when
        ``abort()`` is true and the queue is empty (server stopping).  A
        non-empty queue always yields a request — stop drains before
        exiting."""
        with self._cond:
            while True:
                sel = self._select_class()
                if sel is not None:
                    cls, override = sel
                    return self._pop(cls), override
                if abort() or self._closed:
                    return None, False
                self._cond.wait()

    def get_from(self, cls: int, timeout: float) -> Request | None:
        """Next EDF request from ``cls`` within ``timeout`` seconds (batch
        continuation: batches never mix priority classes)."""
        deadline = time.perf_counter() + max(timeout, 0.0)
        with self._cond:
            while True:
                if self._heaps[cls]:
                    return self._pop(cls)
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._closed:
                    return None
                self._cond.wait(remaining)

    def _pop(self, cls: int) -> Request:
        _, _, r = heapq.heappop(self._heaps[cls])
        self._size -= 1     # owner: callers hold self._cond (get_first/get_from)
        self._cond.notify_all()          # wake blocked producers
        return r

    # -- lifecycle / introspection ---------------------------------------------- #
    def drain(self) -> list[Request]:
        """Remove and return everything still queued (stop's reject pass)."""
        with self._cond:
            out = [r for h in self._heaps for (_, _, r) in h]
            for h in self._heaps:
                h.clear()
            self._size = 0
            self._cond.notify_all()
            return out

    def wake(self) -> None:
        """Nudge the batcher (stop) without enqueuing."""
        with self._cond:
            self._cond.notify_all()

    def close(self) -> None:
        """Refuse future puts and unblock producers parked on a full
        queue — nobody is ever left blocked on a stopped server."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def qsize(self) -> int:
        with self._cond:
            return self._size

    def empty(self) -> bool:
        return self.qsize() == 0

    def depth_upto(self, cls: int) -> int:
        """Queued requests at priority ``cls`` or higher — the work ahead
        of a new ``cls`` submission under strict priority."""
        with self._cond:
            return sum(len(self._heaps[c]) for c in range(cls + 1))

    def depths(self) -> list[int]:
        with self._cond:
            return [len(h) for h in self._heaps]


class RequestQueueServer:
    """Dynamic-batching serving loop over a :class:`PipelineExecutor`.

    A batcher thread collects requests into batches of at most
    ``max_batch`` from the per-class EDF queues (strict priority across
    classes, starvation credit, see :class:`_ClassedQueue`), waiting up to
    ``max_wait_ms`` after a batch's first request before dispatching a
    partial batch.  Batches are issued asynchronously via
    ``executor.submit_many`` (micro-batched when shapes agree) and retired
    by a separate completion thread, so batch ``k+1`` is collected and
    issued while batch ``k`` is still executing — throughput is bounded by
    the executor's token pool, which is also the backpressure signal:
    ``submit`` blocks once ``queue_depth`` (default: pool size) requests
    are waiting, or — with an :class:`AdmissionController` attached —
    sheds instead of blocking (open-loop safety: an overloaded server
    fast-fails rather than stalling its producers).

    Every submitted request resolves **exactly once** into one of four
    terminal outcomes, counted per class: ``served`` (result delivered
    within its deadline), ``shed`` (admission/ladder/queue-full/stop
    fast-fail, never dispatched), ``expired`` (its ``deadline_ms`` passed
    while queued or in flight — :class:`DeadlineExceeded`, the SLO
    violation signal), ``failed`` (executor error).

    **Continuous batching** (``continuous=True``, executor built with
    ``open_groups=True``): the batcher never waits out ``max_wait_ms`` to
    fill a batch.  Each collected request is first *offered to the seam*
    (``executor.try_join``) — a free pad seat in a group still inside its
    stage-0 ring-residency window serves it with zero batching delay —
    and only seam misses are dispatched as a fresh (padded, open) group
    that later arrivals can join in flight.  Admission predictions
    subtract ``executor.seam_capacity()`` from the queue depth, since
    open seats serve queued work without a new dispatch group.
    """

    def __init__(self, executor: PipelineExecutor, *, max_batch: int = 8,
                 max_wait_ms: float = 5.0, queue_depth: int | None = None,
                 plan: Any = None, admission: AdmissionController | None = None,
                 starvation_credit: int = 4, continuous: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if continuous and not getattr(executor, "open_groups", False):
            raise ValueError(
                "continuous batching needs an executor built with "
                "open_groups=True (the join seam is the stage-0 "
                "ring-residency window)")
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        # continuous batching: requests join in-flight groups at the
        # executor's seam (try_join) instead of waiting for the batcher's
        # max-wait window; a miss seeds a new (padded, open) group at once
        self.continuous = bool(continuous)
        if plan is not None:
            # replication-aware sizing: the plan's effective (widened)
            # bottleneck period drives the batching knobs, not the serial one
            self.max_batch, self.max_wait_ms = replication_aware_batching(
                plan, max_batch=max_batch, max_wait_ms=max_wait_ms)
        self._admission = admission
        self._queues = _ClassedQueue(
            queue_depth if queue_depth is not None else executor.pool,
            credit=starvation_credit)
        self._issued: "list | Any" = __import__("queue").Queue()
        self._running = False
        self._batcher: threading.Thread | None = None
        self._retirer: threading.Thread | None = None
        self._done: list[Request] = []
        self._batch_sizes: list[int] = []
        self._seam_joined = 0            # requests admitted via try_join
        self._release_errors: list[BaseException] = []
        self._class_counts = [
            {"submitted": 0, "served": 0, "shed": 0, "expired": 0, "failed": 0}
            for _ in range(N_CLASSES)]
        self._rejected = 0               # failed without serving (stop/shed)
        self._stopped = False
        self._lock = threading.Lock()
        # zero-downtime executor hot-swap (see swap_executor)
        self._swap_lock = threading.Lock()
        self._pending_swap: tuple[PipelineExecutor, threading.Event] | None = None
        self.swaps = 0

    # -- lifecycle ----------------------------------------------------------- #
    def start(self) -> "RequestQueueServer":
        self._running = True
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._retirer = threading.Thread(target=self._retire_loop, daemon=True)
        self._batcher.start()
        self._retirer.start()
        return self

    def stop(self) -> None:
        """Drain the queue, serve everything submitted, then stop.

        Requests that could not be served (racing submitters that enqueue
        after the batcher's final drain pass, producers blocked on a full
        queue) are failed with
        :class:`~repro_torch.core.executor.ExecutorClosed` rather than left
        blocking in ``Request.wait`` until their own timeout.
        """
        self._running = False
        self._queues.wake()             # batcher may be idle-blocked
        if self._batcher is not None:
            self._batcher.join()
        self._issued.put(None)          # retirer sentinel
        if self._retirer is not None:
            self._retirer.join()
        self._stopped = True
        self._queues.close()            # unblock producers; refuse new puts
        self._reject_pending()

    def _reject_pending(self) -> None:
        for r in self._queues.drain():
            self._finish(r, "shed", ExecutorClosed(
                "server stopped before this request was served"))

    def _finish(self, r: Request, outcome: str,
                err: BaseException | None = None,
                dispatched: bool = False) -> None:
        """The single terminal funnel: every request resolves exactly once
        (guarded by ``_finished`` under the server lock), its class
        counter bumps exactly once, and its waiters wake exactly once."""
        with self._lock:
            if r._finished:
                return
            r._finished = True
            if err is not None:
                r.error = err
            if r.t_done is None:
                r.t_done = time.perf_counter()
            self._class_counts[r.priority][outcome] += 1
            if outcome in ("shed", "expired"):
                self._rejected += 1
            if dispatched:
                self._done.append(r)
        r._event.set()
        cb = r.on_finish
        if cb is not None:
            # outside the lock: the hook may free a KV slot / touch the
            # executor; exactly-once is inherited from the _finished guard
            try:
                cb(r)
            except BaseException as e:
                with self._lock:
                    self._release_errors.append(e)

    def _fail_request(self, r: Request, err: BaseException) -> None:
        outcome = "shed"
        if isinstance(err, DeadlineExceeded):
            outcome = "expired"
        elif not isinstance(err, (Overloaded, ExecutorClosed)):
            outcome = "failed"
        self._finish(r, outcome, err)

    def __enter__(self) -> "RequestQueueServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- client API ---------------------------------------------------------- #
    def submit(self, *args: Any, deadline_ms: float | None = None,
               priority: "int | str" = INTERACTIVE,
               on_finish: Any = None) -> Request:
        """Enqueue one request into its priority class.

        Without an admission controller the put blocks when the bounded
        queue is full (closed-loop backpressure).  With one, overload is
        *shed*: the controller fast-fails requests whose deadline the
        predicted queue wait already breaks (and whole classes under the
        degradation ladder), and a full queue refuses the put with
        :class:`Overloaded` instead of blocking the producer.

        ``deadline_ms`` is end-to-end: a request past its deadline is
        failed with :class:`DeadlineExceeded` at whichever point catches
        it first (submit-time prediction, dispatch, or retirement) — never
        returned late.

        ``on_finish`` (called exactly once with the request, on every
        terminal outcome) is where per-request resources — a KV-cache
        slot — are released; it is installed *before* any shed path can
        fire, so a fast-failed request still returns its slot.
        """
        pri = priority_of(priority)
        r = Request(args=args, t_submit=time.perf_counter(),
                    deadline_ms=deadline_ms, priority=pri,
                    on_finish=on_finish)
        with self._lock:
            self._class_counts[pri]["submitted"] += 1
        if self._stopped:
            self._finish(r, "shed", ExecutorClosed(
                "server is stopped; requests are no longer accepted"))
            return r
        adm = self._admission
        if adm is not None:
            in_flight = self.executor.in_flight
            # seam-aware admission: seats already open at the batch seam
            # serve queued work without a fresh dispatch group, so they
            # come off the predicted depth (floored at 0)
            seam = 0
            if self.continuous:
                cap = getattr(self.executor, "seam_capacity", None)
                if cap is not None:
                    seam = int(cap())
            reason = adm.admit(
                priority=pri, deadline_ms=deadline_ms,
                depth_ahead=max(
                    self._queues.depth_upto(pri) + in_flight - seam, 0),
                depth_total=max(
                    self._queues.qsize() + in_flight - seam, 0))
            if reason is not None:
                self._finish(r, "shed", Overloaded(reason))
                return r
        status = self._queues.put(r, block=adm is None)
        if status == "full":
            adm.note_queue_full(pri)
            self._finish(r, "shed", Overloaded(
                f"request queue full ({self._queues.maxsize} deep)"))
            return r
        if status == "closed":
            self._finish(r, "shed", ExecutorClosed(
                "server stopped while this request waited for queue space"))
            return r
        if self._stopped:
            # close the submit/stop race: the drain pass may already have
            # finished when this put landed
            self._reject_pending()
        return r

    def swap_executor(self, new_executor: PipelineExecutor, *,
                      warm_args: tuple | None = None,
                      timeout: float = 120.0,
                      plan: Any = None, ir: Any = None,
                      db: Any = None, inventory: Any = None,
                      ) -> PipelineExecutor:
        """Zero-downtime executor hot-swap (the adaptive re-plan deploy).

        0. **Verify off-path** — when the caller hands over the candidate's
           ``plan`` + ``ir`` (and optionally its ``db``/``inventory``),
           the static verifier re-checks the plan *before* warmup or
           publication; a failing candidate raises
           :class:`~repro_torch.analysis.diagnostics.PlanVerificationError`
           and the server keeps serving on the old executor
           (``REPRO_VERIFY=off`` skips the gate).
        1. **Warm off-path** — when ``warm_args`` is given, the new
           executor's ``warmup`` runs every bucket shape *before* it sees
           traffic (first-call costs: kernel builds, library handles, the
           allocator's growth).
        2. **Swap at a batch boundary** — the batcher thread installs the
           new executor between batches, so no batch is split across
           executors.
        3. **Drain in flight** — batches already issued keep their
           ``PendingToken`` handles into the *old* executor; the retire
           thread resolves them as usual.  Nothing is cancelled, no
           request is dropped.

        Blocks until the batcher performed the swap (immediately when the
        server is not running) and returns the old executor — the caller
        may ``drain()``/``close()`` it once its stats are harvested.
        """
        if plan is not None and ir is not None:
            from ..analysis.verify import check_plan
            check_plan(ir, plan, db=db, inventory=inventory,
                       where="RequestQueueServer.swap_executor")
        if warm_args is not None:
            new_executor.warmup(*warm_args)
        done = threading.Event()
        with self._swap_lock:
            if self._pending_swap is not None:
                raise RuntimeError("another executor swap is in progress")
            # capture BEFORE publishing: once the pending swap is visible a
            # fast batcher may install new_executor at any moment
            old = self.executor
            self._pending_swap = (new_executor, done)
        if not self._running:             # no batcher: swap synchronously
            self._maybe_swap()
        else:
            self._queues.wake()           # idle batcher blocks on the queue
            if not done.wait(timeout):
                # withdraw the offer so a stalled batcher can't install a
                # swap the caller already gave up on; if the batcher took
                # it in this instant, the swap DID happen
                with self._swap_lock:
                    if self._pending_swap is not None \
                            and self._pending_swap[1] is done:
                        self._pending_swap = None
                        raise TimeoutError(
                            "executor swap not performed within timeout")
        return old

    def _maybe_swap(self) -> None:
        """Install a pending executor; called between batches (batcher)."""
        with self._swap_lock:
            pend, self._pending_swap = self._pending_swap, None
        if pend is None:
            return
        new_ex, done = pend
        self.executor = new_ex
        self.swaps += 1
        done.set()

    def slo_violation_rate(self, priority: int | None = None) -> float:
        """Fraction of *completed* requests (served or expired) that
        missed their deadline — the SLO signal
        :meth:`~repro_torch.runtime.driver.ElasticPlanner.
        replan_from_profile` takes beside the stage medians."""
        with self._lock:
            classes = range(N_CLASSES) if priority is None else [priority]
            served = sum(self._class_counts[c]["served"] for c in classes)
            expired = sum(self._class_counts[c]["expired"] for c in classes)
        total = served + expired
        return (expired / total) if total else 0.0

    def stats(self) -> dict:
        """Per-request latency summary (overall + per class) + executor
        throughput counters + admission-controller state."""
        with self._lock:         # one snapshot: latencies, sizes, span agree
            ok = [r for r in self._done if r.error is None]
            lat = [r.latency_ms for r in ok if r.latency_ms is not None]
            queue_ms = [r.queue_ms for r in self._done
                        if r.queue_ms is not None]
            sizes = list(self._batch_sizes)
            done = list(self._done)
            counts = [dict(c) for c in self._class_counts]
        span_s = 0.0
        if done:
            span_s = (max(r.t_done for r in done)
                      - min(r.t_submit for r in done))
        classes = {}
        for c, name in enumerate(PRIORITY_CLASSES):
            class_lat = [r.latency_ms for r in done
                         if r.priority == c and r.error is None
                         and r.latency_ms is not None]
            entry = dict(counts[c])
            entry["latency_ms"] = _latency_summary(class_lat)
            classes[name] = entry
        return {
            "requests_served": sum(c["served"] for c in counts),
            "batches": len(sizes),
            "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
            "throughput_rps": (len(lat) / span_s) if span_s > 0 else 0.0,
            "latency_ms": _latency_summary(lat),
            "queue_ms_mean": float(np.mean(queue_ms)) if queue_ms else 0.0,
            "queue_depth": self._queues.qsize(),
            "class_queue_depths": self._queues.depths(),
            "rejected": self._rejected,
            "shed": sum(c["shed"] for c in counts),
            "expired": sum(c["expired"] for c in counts),
            "failed": sum(c["failed"] for c in counts),
            "submitted": sum(c["submitted"] for c in counts),
            "classes": classes,
            "seam_joins": self._seam_joined,
            "release_errors": len(self._release_errors),
            "slo_violation_rate": self.slo_violation_rate(),
            "admission": (self._admission.snapshot()
                          if self._admission is not None else None),
            "swaps": self.swaps,
            "executor": self.executor.stats().as_dict(),
            "profile": (self.executor.profiler.snapshot()
                        if getattr(self.executor, "profiler", None) is not None
                        else None),
        }

    # -- server threads ------------------------------------------------------ #
    def _abort_collect(self) -> bool:
        # read without _swap_lock: a stale None only delays the swap by one
        # wake (swap_executor wakes the queue after publishing)
        return not self._running or self._pending_swap is not None

    def _collect_batch(self) -> list[Request]:
        first, credit_override = self._queues.get_first(self._abort_collect)
        if first is None:
            return []
        batch = [first]
        if credit_override:
            # starvation-credit grant: a single-request trickle batch, so
            # the still-backlogged higher class resumes immediately after
            return batch
        wait_ms = self.max_wait_ms
        if self._admission is not None:
            wait_ms *= self._admission.max_wait_scale()
        deadline = time.perf_counter() + wait_ms / 1e3
        while len(batch) < self.max_batch:
            if self.continuous:
                # continuous batching never holds a request back to fill
                # a batch: take what is queued right now, dispatch, and
                # let late arrivals join the group at the executor seam
                nxt = self._queues.get_from(first.priority, 0.0)
                if nxt is None:
                    break
                batch.append(nxt)
                continue
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            # batches never mix classes: EDF continuation from the first
            # request's class only
            nxt = self._queues.get_from(first.priority, remaining)
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _refresh_admission_period(self) -> None:
        """Feed the admission rule the measured dispatch-group period and
        close one pressure-observation window (the level-2 streak tick)."""
        adm = self._admission
        if adm is None:
            return
        adm.end_window()
        prof = getattr(self.executor, "profiler", None)
        if prof is None or not hasattr(prof, "effective_period_ms"):
            return
        period = prof.effective_period_ms(
            getattr(self.executor, "replicas", None))
        if period is not None:
            adm.update_period(period)

    def _batch_loop(self) -> None:
        while self._running or not self._queues.empty():
            self._maybe_swap()            # executor swaps at batch boundaries
            batch = self._collect_batch()
            if not batch:
                continue
            self._refresh_admission_period()
            t_batch = time.perf_counter()
            # degrade past-deadline requests instead of dispatching late:
            # they failed their SLO while queued, executing them anyway
            # would only delay the requests still inside theirs
            live: list[Request] = []
            for r in batch:
                if t_batch > r.deadline_at:
                    self._finish(r, "expired", DeadlineExceeded(
                        f"request missed its {r.deadline_ms:g} ms deadline "
                        "while queued"))
                else:
                    live.append(r)
            batch = live
            if not batch:
                continue
            for r in batch:
                r.t_batch = t_batch
            if self.continuous:
                # offer every request to the seam first: a free seat in an
                # in-flight group serves it without waiting for a fresh
                # dispatch group (the joined token retires with its
                # adoptive group, in that group's place)
                rest: list[Request] = []
                joined = 0
                for r in batch:
                    try:
                        h = self.executor.try_join(r.args)
                    except ExecutorClosed:
                        h = None         # submit_many below reports it
                    except BaseException as e:
                        self._finish(r, "failed", e)
                        continue
                    if h is not None:
                        joined += 1
                        self._issued.put((r, h))
                    else:
                        rest.append(r)
                if joined:
                    # seam joins rode along inside groups already
                    # dispatched, so _batch_sizes (the dispatch-group log)
                    # deliberately excludes them
                    with self._lock:
                        self._seam_joined += joined
                batch = rest
                if not batch:
                    continue
            try:
                # eager async issue; blocks only on token-pool backpressure
                handles = self.executor.submit_many([r.args for r in batch])
            except BaseException as first_err:
                # SubmitError carries handles for the prefix that WAS
                # admitted — keep those (never double-issue device work)
                # and retry only the remainder one-by-one so just the
                # malformed request(s) fail
                handles = list(getattr(first_err, "handles", []) or [])
                good: list[Request] = batch[:len(handles)]
                for r in batch[len(handles):]:
                    try:
                        handles.extend(self.executor.submit_many([r.args]))
                        good.append(r)
                    except BaseException as e:
                        self._finish(r, "failed",
                                     getattr(e, "__cause__", None) or e)
                batch = good
                if not batch:
                    continue
            with self._lock:
                self._batch_sizes.append(len(batch))
            for r, h in zip(batch, handles):
                self._issued.put((r, h))
        self._maybe_swap()                # never leave a swap waiter hanging

    def _retire_loop(self) -> None:
        while True:
            item = self._issued.get()
            if item is None:
                return
            r, handle = item
            try:
                result = handle.result()
            except BaseException as e:
                r.t_done = time.perf_counter()
                self._finish(r, "failed", e, dispatched=True)
                continue
            r.t_done = time.perf_counter()
            if r.t_done > r.deadline_at:
                # end-to-end deadline: a request that went past its SLO
                # while in flight is failed at retirement, not returned
                # late — the result is discarded, the violation counted
                self._finish(r, "expired", DeadlineExceeded(
                    f"request completed {((r.t_done - r.t_submit) * 1e3):.1f}"
                    f" ms after submit, past its {r.deadline_ms:g} ms "
                    "deadline"), dispatched=True)
                continue
            r.result = result
            self._finish(r, "served", dispatched=True)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (inf when ``got`` is not finite)."""
    if not bool(torch.isfinite(got).all()):
        return math.inf
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def serve_pipeline_demo(n_requests: int = 64, max_batch: int = 8,
                        max_wait_ms: float = 4.0,
                        size: tuple[int, int] = (64, 96),
                        worker_budget: "int | str | None" = None,
                        devices: int | None = None, device=None) -> dict:
    """Smoke-servable demo: the Harris pipeline behind the request queue.

    The database carries the CUDA modules (K1-K3 run on the card; on the
    CPU their plain versions), so the executor drives slice 1's kernels.
    ``worker_budget`` serves the pipeline with replicated stages (the
    planner's widening pass, :func:`~repro_torch.core.partition.
    widen_for_deployment`), retiring requests strictly in submission order;
    ``devices=N`` places replicas on the first N cards.  A widened plan
    also re-derives the batching knobs from its effective bottleneck period
    (:func:`replication_aware_batching`).  ``results_match`` holds every
    served frame to the plain app on the same device (1e-3, the main
    path's tolerance), and ``max_abs_err`` is the largest difference.
    """
    from ..core import DeviceInventory, courier_offload, resolve_device
    from ..core.partition import widen_for_deployment
    from ..core.tracer import Library
    from ..models.harris import corner_harris_demo, make_frames, make_harris_db

    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    dev = resolve_device(device)
    db = make_harris_db(with_hw=True)
    app = corner_harris_demo(Library(db))
    H, W = size
    frames = make_frames(n_requests, H, W, seed=0, device=dev)
    off = courier_offload(app, frames[0], db=db)
    inventory = (DeviceInventory.detect(limit=devices, device=dev)
                 if devices else None)
    plan = off.pipeline.plan
    replicas, stage_devices = widen_for_deployment(
        plan, off.pipeline.ir, worker_budget=worker_budget,
        inventory=inventory)
    if replicas is not None:
        max_batch, max_wait_ms = replication_aware_batching(
            plan, max_batch=max_batch, max_wait_ms=max_wait_ms)
    ex = off.pipeline.executor(microbatch=max_batch, pad_microbatches=True,
                               replicas=replicas, devices=stage_devices,
                               inventory=inventory)
    warm = ex.warmup(frames[0])

    try:
        with RequestQueueServer(ex, max_batch=max_batch,
                                max_wait_ms=max_wait_ms) as srv:
            reqs = [srv.submit(f) for f in frames]
            results = [r.wait(timeout=600.0) for r in reqs]
    finally:
        ex.close()
    plain = corner_harris_demo(Library(make_harris_db(with_hw=False)))
    err = max(float((y - plain(f)).abs().max())
              for y, f in zip(results, frames))
    stats = srv.stats()
    stats.update({"results_match": err <= 1e-3, "max_abs_err": err,
                  "n_stages": plan.n_stages, "warmup_groups": warm,
                  "replicas": list(replicas) if replicas is not None
                  else None})
    return stats


def serve_traced_transformer_demo(n_requests: int = 24, max_batch: int = 4,
                                  max_wait_ms: float = 4.0,
                                  seq_len: int = 32, d: int = 64,
                                  n_layers: int = 2, ff: int = 128,
                                  n_heads: int = 4, vocab: int = 128,
                                  worker_budget: "int | str | None" = None,
                                  devices: int | None = None,
                                  device=None) -> dict:
    """The general trace→serve path: a transformer forward pass traced by
    the Frontend (weights closed over, no model-code edits), lowered
    through partition→fusion→replication→verify, served behind the
    request queue.

    Each request is one ``[seq_len, d]`` embedding sequence; the weights
    and the requests are drawn from seeded generators (``torch.Generator``)
    on the device (the card unless ``device="cpu"``).  Returns the server stats
    plus trace-path facts: the fused nodes (the rmsnorm+matmul kernel, K6,
    must fire on the traced lm head), the hw nodes and their fn keys, the
    number of captured weight inputs, the groups ``warmup`` ran, and
    ``results_match`` — every served result held to the port's own
    untraced app on the same device.  That comparison cannot be bitwise
    (cuBLAS may pick another algorithm for a stacked group's product than
    for one sequence's), so it is ``max|Δ| / max|ref| <= 2e-4``, the
    reference's f32 tolerance, and ``max_rel_err`` carries the error.
    ``device_ms_per_group`` is the card's own time for one dispatch group
    through every stage (the sum of the stage medians, timed by CUDA
    events; the host clock on the CPU).
    """
    from ..core import (DeviceInventory, PipelineGenerator, StageProfiler,
                        resolve_device)
    from ..core.partition import widen_for_deployment
    from ..core.placement import is_hw
    from ..core.tracer import Frontend, Library
    from ..models.zoo import (init_transformer_params, make_zoo_db,
                              transformer_demo)

    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    dev = resolve_device(device)
    db = make_zoo_db()
    lib = Library(db)
    params = init_transformer_params(
        torch.Generator(device=dev).manual_seed(0), n_layers=n_layers, d=d,
        ff=ff, n_heads=n_heads, vocab=vocab, device=dev)
    app = transformer_demo(lib, params)
    gen = torch.Generator(device=dev).manual_seed(100)
    seqs = [torch.randn((seq_len, d), generator=gen, dtype=torch.float32,
                        device=dev) for _ in range(n_requests)]

    ir, _ = Frontend(db).trace(app, seqs[0])
    pipe = PipelineGenerator(db).generate(ir, policy="optimal", fuse=True,
                                          max_stages=4)
    inventory = (DeviceInventory.detect(limit=devices, device=dev)
                 if devices else None)
    plan = pipe.plan
    replicas, stage_devices = widen_for_deployment(
        plan, pipe.ir, worker_budget=worker_budget, inventory=inventory)
    if replicas is not None:
        max_batch, max_wait_ms = replication_aware_batching(
            plan, max_batch=max_batch, max_wait_ms=max_wait_ms)
    profiler = StageProfiler(plan.n_stages, sample_every=1, min_samples=1)
    ex = pipe.executor(microbatch=max_batch, pad_microbatches=True,
                       replicas=replicas, devices=stage_devices,
                       inventory=inventory, profiler=profiler)
    warm = ex.warmup(seqs[0])

    try:
        with RequestQueueServer(ex, max_batch=max_batch,
                                max_wait_ms=max_wait_ms) as srv:
            reqs = [srv.submit(s) for s in seqs]
            results = [r.wait(timeout=600.0) for r in reqs]
    finally:
        ex.close()

    # the port's own untraced app (outside any trace/deploy context every
    # lib call takes its plain software row) on the same device
    err = max(_rel_err(y, app(s)) for y, s in zip(results, seqs))
    meds = [profiler.percentile_ms(k) for k in range(plan.n_stages)]
    stats = srv.stats()
    stats.update({
        "results_match": err <= 2e-4,
        "max_rel_err": err,
        "n_nodes": len(pipe.ir.nodes),
        "n_stages": plan.n_stages,
        "stages": [list(s.node_names) for s in plan.stages],
        "fused_nodes": [n.name for n in pipe.ir.nodes if n.fused_from],
        "hw_nodes": {n.name: n.fn_key for n in pipe.ir.nodes
                     if is_hw(n.placement)},
        "captured_inputs": len(pipe.captured),
        "token_inputs": len(pipe.graph_inputs),
        "replicas": list(replicas) if replicas is not None else None,
        "warmup_groups": warm,
        "device_ms_per_group": (sum(meds) if all(m is not None for m in meds)
                                else None),
    })
    return stats


def lm_config(arch: str = "gemma3-12b", *, reduced: bool = True,
              layers: int | None = None):
    """The ``ArchConfig`` the LM mode serves: ``arch``, reduced to a tiny
    same-family config unless ``reduced=False``, cut to ``layers`` layers
    when given (widths unchanged)."""
    from ..configs import get_config

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve_lm(cfg, params: Any = None, prompt: Any = None, *, batch: int = 4,
             prompt_len: int = 32, tokens: int = 32, device=None,
             keep_logits: bool = False, img_embeds: Any = None) -> dict:
    """Batched prefill + KV-cache greedy decode on the LM stack.

    The JAX package's ``--mode lm`` loop: prefill the prompt into a cache of
    ``prompt_len + tokens`` rows, take the argmax of the last position's
    logits, then ``tokens`` decode steps, each feeding back its argmax.
    ``params`` default to ``LM.init`` from a ``torch.Generator`` seeded with
    0 on the device; ``prompt`` (ids ``[B, P]``, any array) defaults to
    numpy ``default_rng(1)`` draws of ``[batch, prompt_len]``.  A vlm
    model's prefill also takes ``img_embeds`` (``[B, n_img_tokens, d]``,
    any array), which default to numpy ``default_rng(2)`` normal draws; they
    reach the model in the config's dtype (the JAX loop's f32 draws into a
    bf16 model break its layer scan).

    Returns the stats: prefill ms and tokens/s, the card's own prefill ms
    (CUDA events; None on the CPU), decode ms/token and tokens/s, the
    generated ``ids`` (numpy ``[B, tokens]``), K7's launches in the prefill
    and in the decode loop, and whether every logit was finite.  With
    ``keep_logits`` also ``logits``, ``[B, tokens + 1, vocab]`` f32: the
    prefill's last position and every decode step's, i.e. the logits at
    positions ``P - 1 .. P + tokens - 1``.
    """
    from ..core import resolve_device
    from ..kernels.flash_attention import LAUNCHES
    from ..models import LM
    from ..models.transformer import torch_dtype

    dev = resolve_device(device)
    model = LM(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    if prompt is None:
        prompt = np.random.default_rng(1).integers(
            0, cfg.vocab, (batch, prompt_len))
    ids = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
    B, P = ids.shape
    table = params["embed"]["table"]

    def step_in(t):          # (ids, embeds) of a step, as the JAX loop feeds
        return (None, table[t]) if cfg.embeds_in else (t, None)

    img = {}
    if cfg.cross_attn_every:
        if img_embeds is None:
            img_embeds = np.random.default_rng(2).standard_normal(
                (B, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
        if not isinstance(img_embeds, torch.Tensor):
            img_embeds = torch.from_numpy(np.asarray(img_embeds, np.float32))
        img["img_embeds"] = img_embeds.to(device=dev,
                                          dtype=torch_dtype(cfg.dtype))

    cache = model.init_cache(B, P + tokens, device=dev)
    _sync(dev)
    k7 = LAUNCHES["flash_attention"]
    ev = ((torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) if dev.type == "cuda"
          else None)
    t0 = time.perf_counter()
    if ev:
        ev[0].record()
    x, e = step_in(ids)
    hp, cache = model.prefill(params, x, cache, embeds=e, **img)
    logits = model.logits(params, hp)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    if ev:
        ev[1].record()
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    k7_prefill = LAUNCHES["flash_attention"] - k7

    kept = [logits[:, -1]] if keep_logits else []
    finite = torch.isfinite(logits).all()       # on the device: no sync
    out = []
    t0 = time.perf_counter()
    for t in range(tokens):
        out.append(tok)
        x, e = step_in(tok)
        logits, cache = model.decode_step(params, x, cache, P + t, embeds=e)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        finite = finite & torch.isfinite(logits).all()
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0

    stats = {
        "arch": cfg.arch_id, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
        "batch": B, "prompt_len": P, "tokens": tokens, "device": str(dev),
        "prefill_ms": 1e3 * t_prefill,
        "prefill_tok_s": B * P / t_prefill,
        "prefill_device_ms": ev[0].elapsed_time(ev[1]) if ev else None,
        "decode_ms_per_token": 1e3 * t_decode / tokens if tokens else None,
        "decode_tok_s": B * tokens / t_decode if tokens else None,
        "ids": (torch.cat(out, dim=1).cpu().numpy() if out
                else np.zeros((B, 0), np.int64)),
        "k7_launches_prefill": k7_prefill,
        "k7_launches_decode": LAUNCHES["flash_attention"] - k7 - k7_prefill,
        "finite": bool(finite),
    }
    if keep_logits:
        stats["logits"] = torch.stack(kept, dim=1)
    return stats


def _budget_arg(v: str):
    """argparse type for --worker-budget: an int or the 'auto' sentinel,
    rejected with a clean argparse error instead of an int() traceback."""
    from ..core.placement import AUTO_BUDGET

    if v == AUTO_BUDGET:
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {v!r}")


def main(argv: list[str] | None = None) -> None:
    from ..configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["lm", "pipeline", "trace"],
                    default="lm")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-12b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="a tiny same-family config (default); "
                         "--no-reduced serves the full widths")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--worker-budget", type=_budget_arg, default=None,
                    help="total stage workers; > n_stages widens "
                         "(replicates) the bottleneck stages; 'auto' "
                         "derives the budget from os.cpu_count() minus "
                         "the REPRO_RESERVED_CORES headroom")
    ap.add_argument("--devices", type=int, default=None,
                    help="place stage replicas on the first N detected "
                         "cards; each replica of a widened stage is pinned "
                         "to its own card")
    args = ap.parse_args(argv)

    if args.mode == "lm":
        cfg = lm_config(args.arch, reduced=args.reduced, layers=args.layers)
        st = serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      tokens=args.tokens, device=args.device)
        if not st["finite"]:
            raise RuntimeError("non-finite logits")
        print(f"[serve] arch={cfg.arch_id} layers={cfg.n_layers} "
              f"dtype={cfg.dtype} batch={st['batch']} "
              f"prompt={st['prompt_len']} device={st['device']}")
        print(f"[serve] prefill: {st['prefill_ms']:.1f} ms "
              f"({st['prefill_tok_s']:.0f} tok/s), flash-attention launches "
              f"{st['k7_launches_prefill']}")
        if args.tokens:
            print(f"[serve] decode: {st['decode_ms_per_token']:.2f} ms/token "
                  f"({st['decode_tok_s']:.0f} tok/s), generated "
                  f"{tuple(st['ids'].shape)}")
        return

    if args.mode == "trace":
        stats = serve_traced_transformer_demo(
            n_requests=args.requests, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, worker_budget=args.worker_budget,
            devices=args.devices, device=args.device)
        lat = stats["latency_ms"]
        print(f"[serve] traced transformer: {stats['requests_served']} "
              f"requests over {stats['n_stages']} stages "
              f"(fused: {stats['fused_nodes']}, "
              f"{stats['captured_inputs']} captured weights)")
        print(f"[serve] results match the untraced app: "
              f"{stats['results_match']} (max rel err "
              f"{stats['max_rel_err']:.3g})")
        print(f"[serve] latency ms: mean={lat['mean']:.2f} "
              f"p50={lat['p50']:.2f} p95={lat['p95']:.2f} max={lat['max']:.2f}")
        return

    stats = serve_pipeline_demo(n_requests=args.requests,
                                max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms,
                                worker_budget=args.worker_budget,
                                devices=args.devices, device=args.device)
    lat = stats["latency_ms"]
    print(f"[serve] pipeline mode: {stats['requests_served']} requests, "
          f"{stats['batches']} batches "
          f"(mean size {stats['mean_batch_size']:.1f}); results match the "
          f"plain app: {stats['results_match']}")
    print(f"[serve] latency ms: mean={lat['mean']:.2f} "
          f"p50={lat['p50']:.2f} p95={lat['p95']:.2f} max={lat['max']:.2f}")
    print(f"[serve] executor: {stats['executor']}")


if __name__ == "__main__":
    main()
