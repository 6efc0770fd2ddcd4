"""Asynchronous token-pipeline executor (TBB ``parallel_pipeline`` analog).

:class:`BuiltPipeline.run` emulates TBB's token pipeline with a *synchronous
wavefront*: a Python loop that advances every in-flight token by one stage
per host step.  This module replaces it with an asynchronous executor that
leans on CUDA's asynchronous launches the way TBB leans on its thread pool:

* **Eager issue** — when a token is admitted, *all* of its stage calls are
  issued immediately.  A stage's kernels return before the card finishes,
  so stage ``s+1`` is enqueued behind stage ``s`` on the stream and the
  host never waits between stages.  Work for token ``k+1`` is therefore
  issued while token ``k`` is still executing — the paper's "Task #0 can
  take the second input while Task #1 is processing".
* **Bounded token pool** — at most ``max_in_flight`` tokens are
  issued-but-unretired at any moment (TBB's token pool; default
  ``n_stages + 1``).  Admission blocks on the *oldest* token's final
  outputs when the pool is full, which is also the serving layer's
  backpressure mechanism.  ``max_in_flight`` must be >= 1.
* **Per-stage micro-batching** — consecutive tokens whose input
  shapes/dtypes agree are stacked along a new leading axis and pushed
  through the stages as one group (``microbatch=m``).  The JAX package
  applies ``jax.vmap`` to each stage; ``torch.func.vmap`` cannot see inside a
  kernel called through ``ctypes``, so here a stage whose library rows all
  take leading batch dims (``ModuleEntry.batch_dims``) gets the stacked
  group in one call — one launch per kernel for the whole group — and any
  other stage is run once per row and restacked (:func:`~repro_torch.core.
  pipeline.loop_batched`).  Results are unstacked at retirement, so the API
  is token-in/token-out either way.
* **Counters** — per-stage issue counts/host-issue time and pool occupancy;
  :meth:`PipelineExecutor.stats` exposes throughput and occupancy for the
  serving layer's metrics endpoint.
* **Online profiling** — an attached :class:`~repro_torch.core.profiler.
  StageProfiler` is fed per-stage times: exactly in threaded mode, and in
  async mode for every ``profiler.sample_every``-th group, timed by a CUDA
  event pair around each stage and read at retirement (no host wait).
* **Threaded stage workers** (``stage_workers=True``) — one serial worker
  thread per stage, TBB's execution model, for host-bound stages.
* **Replicated stages** (``replicas=[r0, r1, ...]``) — TBB's *parallel*
  filter kind: stage ``s`` runs ``r_s`` worker threads fed by
  sequence-numbered rings (:class:`_SeqRing`), with a reorder buffer at
  retirement so tokens retire in submission order even when replicas
  finish out of order (``ExecutorStats.out_of_order_retired`` stays 0).
* **Replica quarantine + bounded retry** — a stage exception on a
  replicated stage is retried (locally, or on a sibling after quarantine),
  bounded by ``max_group_retries`` and ``retry_budget_ms``; a replica whose
  errors reach ``quarantine_after`` is evicted and its sequence residues
  move to healthy siblings.  The last healthy replica of a stage is never
  quarantined, and unreplicated stages error the group.  Scripted faults
  come from a :class:`~repro_torch.runtime.faults.FaultInjector` called in
  front of every stage body.

**Streams.** Every stage runs on its device's default stream, whichever
thread issues it: a new thread's current stream is the default one, and the
executor never switches streams.  So the hand-offs between stages, threads
and replicas are ordered on the card by the stream itself, and the caching
allocator, which reuses a freed block only behind work already queued on the
same stream, cannot hand a tensor's memory out early.  A thread that must
see a result on the host waits on a CUDA event recorded behind it.

Completion is in-order (tokens retire oldest-first), matching the paper's
``serial_in_order`` first/last filters.  The continuous-batching seam of the
JAX package (``open_groups``, ``try_join``, ``try_evict``) waits for the
per-request KV-slot slice.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import torch

from .ir import flatten

__all__ = ["PipelineExecutor", "ExecutorStats", "StageCounters",
           "PendingToken", "SubmitError", "ExecutorClosed"]


class ExecutorClosed(RuntimeError):
    """Submission raced (or followed) :meth:`PipelineExecutor.close`.

    Raised instead of hanging: a submitter blocked on token-pool
    backpressure when ``close()`` lands would otherwise be admitted into
    already-closed replica rings, whose completion event never fires.
    ``close()`` publishes ``closed`` under the executor lock *before*
    draining, and the admission loop re-checks it under the same lock, so
    every group that wins admission is visible to close's drain and every
    loser gets this exception — never a silent drop.
    """


class SubmitError(RuntimeError):
    """A submit_many call failed after part of the stream was admitted.

    ``handles`` are PendingTokens for the prefix of the token stream that
    WAS issued (possibly empty); everything from index ``len(handles)``
    onward was not admitted.  ``__cause__`` carries the original error.
    """

    def __init__(self, msg: str, handles: list["PendingToken"]):
        super().__init__(msg)
        self.handles = handles


# --------------------------------------------------------------------------- #
# Counters
# --------------------------------------------------------------------------- #
@dataclass
class StageCounters:
    """Per-stage issue-side counters (host view; device time is async)."""

    issued: int = 0        # stage invocations (one per token group)
    tokens: int = 0        # tokens pushed through this stage
    errors: int = 0        # stage-call failures (pre-retry; see retries)
    issue_ms: float = 0.0  # host time spent dispatching this stage
    # measured stage-body wall time (threaded/sampled only); disjoint from
    # xfer_ms — exec_ms + xfer_ms is the stage's full service time
    exec_ms: float = 0.0
    xfer_ms: float = 0.0   # host time staging groups onto pinned devices
    replicas: int = 1      # worker threads serving this stage
    # CONFIGURED per-replica device ordinals (empty = unpinned).  This
    # echoes the plan; when the executor degraded to a single device the
    # pinning is not in effect (xfer_ms stays 0 and profiler samples carry
    # no device ordinal).
    devices: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"issued": self.issued, "tokens": self.tokens,
                "errors": self.errors,
                "issue_ms": round(self.issue_ms, 4),
                "exec_ms": round(self.exec_ms, 4),
                "xfer_ms": round(self.xfer_ms, 4),
                "replicas": self.replicas,
                "devices": list(self.devices)}


@dataclass
class ExecutorStats:
    """Snapshot of executor activity since construction (or ``reset``)."""

    per_stage: list[StageCounters] = field(default_factory=list)
    tokens_admitted: int = 0
    tokens_retired: int = 0
    groups_admitted: int = 0
    max_in_flight_seen: int = 0
    occupancy_samples: int = 0
    occupancy_sum: int = 0
    wall_ms: float = 0.0           # accumulated blocking run() wall time
    out_of_order_retired: int = 0  # groups retired out of submission order
    tokens_failed: int = 0         # tokens retired carrying an error
    retries: int = 0               # failed stage calls re-executed
    quarantined: int = 0           # replicas evicted after repeated errors
    # failed stage calls per CONFIGURED device ordinal — the replanner's
    # unhealthy-device signal (populated only for device-placed replicas)
    device_errors: dict = field(default_factory=dict)
    quarantined_replicas: list = field(default_factory=list)  # (stage, w)

    @property
    def mean_occupancy(self) -> float:
        if not self.occupancy_samples:
            return 0.0
        return self.occupancy_sum / self.occupancy_samples

    @property
    def throughput_tps(self) -> float:
        """Retired tokens per second over the accumulated ``run`` wall time."""
        if self.wall_ms <= 0:
            return 0.0
        return self.tokens_retired / (self.wall_ms / 1e3)

    def as_dict(self) -> dict:
        return {
            "tokens_admitted": self.tokens_admitted,
            "tokens_retired": self.tokens_retired,
            "groups_admitted": self.groups_admitted,
            "max_in_flight_seen": self.max_in_flight_seen,
            "out_of_order_retired": self.out_of_order_retired,
            "tokens_failed": self.tokens_failed,
            "retries": self.retries,
            "quarantined": self.quarantined,
            "device_errors": {str(k): v
                              for k, v in sorted(self.device_errors.items())},
            "quarantined_replicas": [list(t)
                                     for t in self.quarantined_replicas],
            "mean_occupancy": round(self.mean_occupancy, 3),
            "wall_ms": round(self.wall_ms, 3),
            "throughput_tps": round(self.throughput_tps, 2),
            "per_stage": [s.as_dict() for s in self.per_stage],
        }


# --------------------------------------------------------------------------- #
# Token signatures (micro-batch grouping)
# --------------------------------------------------------------------------- #
def _sig_of(args: tuple) -> tuple:
    """Shape/dtype signature of one token: tensors (and numpy arrays) by
    their cached ``shape``/``dtype`` attributes, Python scalars by type."""
    sig = []
    for a in args:
        try:
            sig.append((tuple(a.shape), a.dtype))
        except AttributeError:
            sig.append(((), type(a)))
    return tuple(sig)


def _stack(column: Sequence[Any]) -> torch.Tensor:
    """Stack one graph input's rows into a new leading axis."""
    return torch.stack([v if isinstance(v, torch.Tensor)
                        else torch.as_tensor(v) for v in column])


def _cuda_device(tree: Any) -> "torch.device | None":
    """The device of the first CUDA tensor in ``tree`` (None: none)."""
    for t in flatten(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def _wait(tree: Any) -> None:
    """Block the calling thread until the card has produced every CUDA
    tensor in ``tree``: an event recorded behind them on the current stream
    (the one every stage runs on) and waited on.  CPU tensors are ready
    when their op returns."""
    devs = {t.device for t in flatten(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        ev.synchronize()


def _event(dev: torch.device) -> "torch.cuda.Event":
    """A timing event recorded now on ``dev``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


# --------------------------------------------------------------------------- #
# In-flight bookkeeping
# --------------------------------------------------------------------------- #
class _Group:
    """One admitted token group: a (possibly stacked) env fully issued."""

    __slots__ = ("env", "size", "stacked", "results", "done", "error", "lock",
                 "future", "seq", "fns", "evt", "retries", "t_admit",
                 "samples")

    def __init__(self, env: dict | None, size: int, stacked: bool):
        self.env = env                # None until all stages are issued
        self.size = size              # real tokens (padding rows excluded)
        self.stacked = stacked
        self.results: list[Any] | None = None
        self.done = False
        self.error: BaseException | None = None   # stage issue failed
        self.lock = threading.Lock()  # serializes issue + finalization
        self.future: Future | None = None  # last-stage future (threaded mode)
        self.seq: int | None = None   # admission sequence (replicated mode)
        self.fns: tuple | None = None  # resolved stage fns (replicated mode)
        self.evt: threading.Event | None = None  # completion (replicated mode)
        self.retries = 0              # failed stage calls re-executed
        self.t_admit = time.perf_counter()  # retry_budget_ms anchor
        # profiler samples of a sampled group on the card: (stage, start
        # event, end event), read when the group retires
        self.samples: list[tuple] = []


class _SeqRing:
    """Sequence-indexed mailbox feeding ONE replica of ONE stage.

    A ring owns a set of seq RESIDUES (mod the stage width ``r``) and
    consumes each residue's seqs strictly in order.  At construction
    replica ``w`` owns exactly residue ``w`` — group sequence numbers
    ``w, w+r, w+2r, ...`` — and every seq has exactly one producer (the
    upstream worker that completed it), so the hand-off is an SPSC dict
    insert + flag flip; the token envs ride on the group object, so the
    steady path moves one reference, never rebuilds a dict.  The mailbox
    is unbounded but in practice holds at most the token pool (admission
    bounds the in-flight seq span).

    Quarantine is why residues are a *set*: when a sibling replica is
    evicted, this ring :meth:`adopt`\\ s the failed replica's residues
    (with their next-expected seqs) and its undelivered groups are
    re-:meth:`put` here, so the adopted residues resume exactly where the
    failed worker stopped — no seq is skipped, none runs twice.
    """

    __slots__ = ("stride", "slots", "cond", "next", "closed")

    def __init__(self, stride: int, first_seq: int):
        self.stride = stride
        # residue -> next owned seq to consume (starts owning one residue)
        self.next: dict[int, int] = {first_seq % max(stride, 1): first_seq}
        self.slots: dict[int, "_Group"] = {}
        self.cond = threading.Condition(threading.Lock())
        self.closed = False

    def put(self, seq: int, group: "_Group") -> bool:
        """False when the ring is closed (the group was NOT enqueued) —
        callers must fail the group rather than wait on an event no
        worker will ever set."""
        with self.cond:
            if self.closed:
                return False
            self.slots[seq] = group
            self.cond.notify_all()
            return True

    def pop(self) -> "tuple[int, _Group] | None":
        """Block for the next owned seq of any owned residue; ``None``
        once closed."""
        with self.cond:
            while True:
                for res, nxt in self.next.items():
                    g = self.slots.pop(nxt, None)
                    if g is not None:
                        self.next[res] = nxt + self.stride
                        return nxt, g
                if self.closed:
                    return None
                self.cond.wait()

    def adopt(self, residue: int, next_seq: int) -> None:
        """Take ownership of a quarantined sibling's residue, resuming at
        ``next_seq`` (the sibling's consumption watermark)."""
        with self.cond:
            self.next[residue] = next_seq
            self.cond.notify_all()

    def retire(self) -> "tuple[dict[int, _Group], dict[int, int]]":
        """Close the ring and hand back its undelivered groups and
        residue watermarks — the quarantine path re-routes both."""
        with self.cond:
            self.closed = True
            slots, nxt = dict(self.slots), dict(self.next)
            self.slots.clear()
            self.cond.notify_all()
            return slots, nxt

    def close(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()


class PendingToken:
    """Future-like handle for one submitted token (in-order completion)."""

    __slots__ = ("_executor", "_group", "_idx")

    def __init__(self, executor: "PipelineExecutor", group: _Group, idx: int):
        self._executor = executor
        self._group = group
        self._idx = idx

    def done(self) -> bool:
        return self._group.done

    def result(self) -> Any:
        """Block until this token's final outputs are ready and return them."""
        self._executor._retire_through(self._group)
        if self._group.error is not None:
            raise self._group.error
        return self._group.results[self._idx]


# --------------------------------------------------------------------------- #
# The executor
# --------------------------------------------------------------------------- #
class PipelineExecutor:
    """Async token-pipeline executor over stage functions.

    Parameters
    ----------
    stage_fns:
        One callable per stage, ``dict(live-in) -> dict(live-out)`` (the
        output of :func:`repro_torch.core.pipeline.make_stage_fns`).
    graph_inputs / graph_outputs:
        Value names binding positional token args to the stage-0 env and the
        final env to results.
    max_in_flight:
        Token-pool bound (>= 1).  ``None`` defaults to ``n_stages + 1``.
    microbatch:
        Max tokens stacked into one group when their shapes/dtypes agree
        (1 disables batching).  Groups never exceed the pool size.
    pad_microbatches:
        When True, ragged groups (size < ``microbatch``) are padded by
        repeating the last token, so the stages see a closed set of
        leading-axis sizes (the shapes ``warmup`` ran).  Padding rows are
        dropped at retirement.  Singleton groups are exempt: they take the
        per-token stages directly, skipping the stack/unstack round-trip and
        the padded compute.
    buckets:
        With ``pad_microbatches``, the closed set of group sizes to pad up
        to (e.g. ``(1, 2, 4, 8)``).  A ragged group is padded to the
        smallest bucket that fits instead of all the way to ``microbatch``,
        so serving sees one shape per bucket and pads far fewer wasted
        rows.  ``None`` keeps the pad-to-max behavior.
        Bucket sizes above ``microbatch`` are ignored; ``microbatch``
        itself is always an implicit final bucket.
    batched_fns:
        Pre-built group-wide stage list to *share* across executors (see
        ``BuiltPipeline.batched_stage_fns``).  When ``None`` the executor
        builds its own lazily.
    profiler:
        Optional :class:`~repro_torch.core.profiler.StageProfiler` fed
        per-stage times (every stage call in threaded mode; every
        ``profiler.sample_every``-th group in async mode, by CUDA events on
        the card).  ``warmup`` suspends it so first-call costs (kernel builds,
        library handles) never pollute the profile.
    stage_workers:
        Run each stage in its own serial worker thread (the TBB execution
        model): stage ``s+1`` of a group starts when stage ``s`` finished,
        and different stages overlap across OS threads.  Use for pipelines
        whose stage time is host-bound (eager sw fallbacks, callbacks) —
        asynchronous launches alone give those no overlap on the CPU.
    replicas:
        Per-stage worker counts (TBB's *parallel* filters): stage ``s``
        runs on ``replicas[s]`` threads fed by sequence-numbered
        SPSC-per-replica rings, with a reorder buffer guaranteeing
        in-order retirement (see module docstring).  Implies the threaded
        execution model; ``stage_workers`` is ignored when given.  Use
        :func:`repro_torch.core.partition.assign_replicas` to pick the factors
        from measured stage costs.  All-ones is the serial threaded model
        on the ring dataflow.
    devices:
        Per-stage per-replica device ordinals (the planner's
        :meth:`~repro_torch.core.partition.PipelinePlan.stage_devices`):
        replica ``w`` of stage ``s`` copies its groups onto device
        ``devices[s][w]`` (``.to(dev, non_blocking=True)``) before running
        the stage, so a widened stage's replicas run on N distinct cards.
        Requires ``replicas``; row ``s`` must have ``replicas[s]`` entries.
        When every ordinal maps to one device (one card, planning-only
        inventories) the staging hop is skipped entirely.
    inventory:
        The :class:`~repro_torch.core.placement.DeviceInventory` that maps
        ordinals to ``torch.device`` objects; defaults to
        ``DeviceInventory.detect()`` when ``devices`` is given.
    fault_injector:
        Optional :class:`~repro_torch.runtime.faults.FaultInjector` called in
        front of every stage body (all execution modes).  Injected faults
        take the same recovery path as real stage exceptions.
    max_group_retries:
        Retry budget per group across all stages (replicated mode only):
        a group whose stage calls failed this many times errors instead
        of retrying again.
    quarantine_after:
        Errors a single replica may absorb before it is quarantined and
        its seq ownership moves to healthy siblings (default 1: the first
        failure evicts).  The last healthy replica of a stage is never
        quarantined.
    retry_budget_ms:
        Deadline bound on retries: once a group has been in flight this
        long, a failing stage call errors the group instead of retrying —
        late work is degraded, not re-queued forever.  ``None`` (default)
        leaves retries bounded only by ``max_group_retries``.
    """

    def __init__(self, stage_fns: Sequence[Callable],
                 graph_inputs: Sequence[str], graph_outputs: Sequence[str],
                 *, max_in_flight: int | None = None, microbatch: int = 1,
                 pad_microbatches: bool = False,
                 buckets: Sequence[int] | None = None,
                 batched_fns: Sequence[Callable] | None = None,
                 profiler: Any = None, stage_workers: bool = False,
                 replicas: Sequence[int] | None = None,
                 devices: Sequence[Sequence[int]] | None = None,
                 inventory: Any = None, fault_injector: Any = None,
                 max_group_retries: int = 3, quarantine_after: int = 1,
                 retry_budget_ms: float | None = None):
        if max_in_flight is not None and max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1 (got {max_in_flight}); "
                "use None for the default pool of n_stages + 1")
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1 (got {microbatch})")
        self.stage_fns = list(stage_fns)
        self.graph_inputs = list(graph_inputs)
        self.graph_outputs = list(graph_outputs)
        self.replicas: list[int] | None = None
        if replicas is not None:
            reps = [int(r) for r in replicas]
            if len(reps) != len(self.stage_fns):
                raise ValueError(
                    f"replicas must name every stage: got {len(reps)} for "
                    f"{len(self.stage_fns)} stages")
            if any(r < 1 for r in reps):
                raise ValueError(f"replica counts must be >= 1 (got {reps})")
            self.replicas = reps
        self.devices: list[list[int]] | None = None
        self._replica_devs: list[list[Any]] | None = None
        if devices is not None:
            if self.replicas is None:
                raise ValueError("devices= requires replicas= (pass all-ones "
                                 "for a serial device-pinned pipeline)")
            devs = [[int(d) for d in row] for row in devices]
            if len(devs) != len(self.replicas) or any(
                    len(row) != r for row, r in zip(devs, self.replicas)):
                raise ValueError(
                    f"devices must carry one ordinal per replica per stage: "
                    f"got {[len(r) for r in devs]} for replicas "
                    f"{self.replicas}")
            self.devices = devs
            if inventory is None:
                from .placement import DeviceInventory
                inventory = DeviceInventory.detect()
            mapped = [[inventory.torch_device(d) for d in row] for row in devs]
            # single-device degrade: when every ordinal maps to one device
            # there is nothing to stage — skip the copies entirely
            distinct = {d for row in mapped for d in row if d is not None}
            self._replica_devs = mapped if len(distinct) > 1 else None
        if max_in_flight is not None:
            self.pool = max_in_flight
        elif self.replicas is not None:
            # widened stages need proportionally more in-flight tokens to
            # keep every replica busy (double-buffered worker count)
            self.pool = sum(self.replicas) + 1
        else:
            self.pool = len(self.stage_fns) + 1
        self.microbatch = min(microbatch, self.pool)
        self.pad_microbatches = pad_microbatches and self.microbatch > 1
        if buckets is not None:
            bs = sorted({int(b) for b in buckets
                         if 1 <= int(b) <= self.microbatch})
            # microbatch is the explicit final bucket, so _pad_for always
            # lands on a size warmup ran
            self.buckets: tuple[int, ...] | None = tuple(
                bs + ([self.microbatch] if (not bs or bs[-1] != self.microbatch)
                      else []))
        else:
            self.buckets = None
        self._batched_fns: list[Callable] | None = (
            list(batched_fns) if batched_fns is not None else None)
        self.profiler = profiler
        self.stage_workers = bool(stage_workers) and self.replicas is None
        self._pools: list[ThreadPoolExecutor] | None = None
        if self.stage_workers:
            # one SERIAL worker per stage: per-stage ordering is preserved
            # (TBB's serial filters) while distinct stages run concurrently
            self._pools = [
                ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix=f"stage-{i}")
                for i in range(len(self.stage_fns))]
        if max_group_retries < 0:
            raise ValueError(
                f"max_group_retries must be >= 0 (got {max_group_retries})")
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1 (got {quarantine_after})")
        self._injector = fault_injector
        self.max_group_retries = int(max_group_retries)
        self.quarantine_after = int(quarantine_after)
        self.retry_budget_ms = (None if retry_budget_ms is None
                                else float(retry_budget_ms))
        self._inflight: deque[_Group] = deque()
        self._occupancy = 0               # live (non-retired) tokens
        self._lock = threading.RLock()
        self.closed = False
        self._seq = 0                     # admission sequence (replicated)
        self._next_retire_seq = 0         # in-order retirement watermark
        self._rings: list[list[_SeqRing]] | None = None
        self._replica_threads: list[threading.Thread] = []
        self._owner: list[list[int]] | None = None
        self._route_locks: list[threading.Lock] | None = None
        self._healthy: list[list[bool]] | None = None
        self._err_counts: list[list[int]] | None = None
        if self.replicas is not None:
            self._rings = [[_SeqRing(r, w) for w in range(r)]
                           for r in self.replicas]
            # residue -> serving replica; rewritten by _quarantine under
            # the per-stage route lock (serializes against _route)
            self._owner = [list(range(r)) for r in self.replicas]
            self._route_locks = [threading.Lock() for _ in self.replicas]
            self._healthy = [[True] * r for r in self.replicas]
            self._err_counts = [[0] * r for r in self.replicas]
            for si, r in enumerate(self.replicas):
                for w in range(r):
                    t = threading.Thread(
                        target=self._replica_loop, args=(si, w),
                        name=f"stage-{si}-replica-{w}", daemon=True)
                    t.start()
                    self._replica_threads.append(t)
        self._stats = ExecutorStats(per_stage=self._fresh_counters())

    def _fresh_counters(self) -> list[StageCounters]:
        reps = self.replicas or [1] * len(self.stage_fns)
        devs = self.devices or [[] for _ in reps]
        return [StageCounters(replicas=r, devices=list(d))
                for r, d in zip(reps, devs)]

    # -- construction helpers ------------------------------------------------ #
    @classmethod
    def from_pipeline(cls, pipe, *, max_in_flight: int | None = None,
                      microbatch: int = 1,
                      pad_microbatches: bool = False,
                      buckets: Sequence[int] | None = None,
                      profiler: Any = None, stage_workers: bool = False,
                      replicas: Sequence[int] | None = None,
                      devices: Sequence[Sequence[int]] | None = None,
                      inventory: Any = None, fault_injector: Any = None,
                      max_group_retries: int = 3, quarantine_after: int = 1,
                      retry_budget_ms: float | None = None,
                      ) -> "PipelineExecutor":
        """Build from a :class:`repro_torch.core.pipeline.BuiltPipeline`,
        sharing the pipeline's group-wide stage list."""
        mif = max_in_flight if max_in_flight is not None else pipe.max_in_flight
        batched = pipe.batched_stage_fns() if microbatch > 1 else None
        return cls(pipe.stage_fns, pipe.graph_inputs, pipe.graph_outputs,
                   max_in_flight=mif, microbatch=microbatch,
                   pad_microbatches=pad_microbatches, buckets=buckets,
                   batched_fns=batched, profiler=profiler,
                   stage_workers=stage_workers, replicas=replicas,
                   devices=devices, inventory=inventory,
                   fault_injector=fault_injector,
                   max_group_retries=max_group_retries,
                   quarantine_after=quarantine_after,
                   retry_budget_ms=retry_budget_ms)

    # -- public API ---------------------------------------------------------- #
    def submit(self, *args: Any) -> PendingToken:
        """Admit one token (backpressure: blocks while the pool is full)."""
        return self.submit_many([args])[0]

    def submit_many(self, tokens: Iterable[tuple | Any]) -> list[PendingToken]:
        """Admit a token stream, micro-batching compatible neighbors.

        All stages of each admitted group are issued immediately
        (asynchronous launches); the call blocks only when the token pool
        is full, and then only on the oldest group's final outputs.
        Malformed tokens (wrong arity) are rejected up front, before ANY
        token is admitted, so a plain ValueError implies nothing was
        issued.  A later failure (e.g. a shape a stage rejects at issue
        time) raises :class:`SubmitError` carrying the handles of the
        prefix that WAS admitted, so callers never lose — or double-issue —
        work that is already on the device.
        """
        if self.closed:
            raise ExecutorClosed("executor is closed; build a fresh one")
        toks = [t if isinstance(t, tuple) else (t,) for t in tokens]
        for i, t in enumerate(toks):
            if len(t) != len(self.graph_inputs):
                raise ValueError(
                    f"token {i}: expected {len(self.graph_inputs)} inputs, "
                    f"got {len(t)}")
        handles: list[PendingToken] = []
        for group_toks in self._group_tokens(toks):
            try:
                handles.extend(self._admit(group_toks))
            except ExecutorClosed:
                if not handles:
                    raise           # nothing issued: the clean "closed" case
                raise SubmitError(
                    f"executor closed after token {len(handles)}",
                    handles) from None
            except BaseException as e:
                raise SubmitError(
                    f"submit failed at token {len(handles)}: {e}",
                    handles) from e
        return handles

    def run(self, tokens: Iterable[tuple | Any]) -> list[Any]:
        """Blocking map over a token stream; results in submission order."""
        t0 = time.perf_counter()
        handles = self.submit_many(tokens)
        out = [h.result() for h in handles]
        with self._lock:
            self._stats.wall_ms += (time.perf_counter() - t0) * 1e3
        return out

    def drain(self) -> None:
        """Block until every in-flight token has retired."""
        with self._lock:
            last = self._inflight[-1] if self._inflight else None
        if last is not None:
            self._retire_through(last)

    def warmup(self, *args: Any) -> int:
        """Run one example token, and (when batching) one group of every
        bucket size, blocking until done; returns the number of groups it
        ran.  Nothing compiles in eager PyTorch, but the first call of a
        shape builds the CUDA kernels (``nvcc``), creates library handles
        and grows the caching allocator — costs that must not land in the
        first served request's latency.  A device-pinned executor warms
        every replica (one group per replica ring).  The attached profiler
        (if any) is suspended so the first calls never reach the profile;
        the counters are reset afterwards."""
        prof, self.profiler = self.profiler, None
        rounds = max(self.replicas) if (self.replicas is not None
                                        and self._replica_devs is not None) \
            else 1
        groups = 0
        try:
            for _ in range(rounds):
                self.submit(*args).result()
                groups += 1
            if self.microbatch > 1:
                sizes = set(self.buckets or ()) | {self.microbatch}
                for n in sorted(sizes):
                    if n <= 1:
                        continue
                    for _ in range(rounds):
                        for h in self.submit_many([args] * n):
                            h.result()
                        groups += 1
        finally:
            self.profiler = prof
        self.reset_stats()
        return groups

    def close(self) -> None:
        """Drain in-flight work and shut down stage-worker threads.

        Sets ``closed`` so caches (e.g. ElasticPlanner's) never hand a
        shut-down executor back out.  ``closed`` is published under the
        executor lock BEFORE draining: a submitter racing this call either
        wins its pool reservation first (its group is then in ``_inflight``
        and the drain below retires it) or observes ``closed`` inside the
        admission loop and raises :class:`ExecutorClosed` — it can never
        be admitted into the rings this method is about to close.
        """
        with self._lock:
            self.closed = True
        self.drain()
        if self._pools is not None:
            for p in self._pools:
                p.shutdown(wait=True)
        if self._rings is not None:
            for stage_rings in self._rings:
                for ring in stage_rings:
                    ring.close()
            for t in self._replica_threads:
                t.join(timeout=30.0)

    def compile_count(self) -> int:
        """Executables compiled for the stages: 0 in eager PyTorch, where
        nothing is traced or compiled (kept so serving code written against
        the JAX package's zero-recompile invariant reads the same)."""
        return sum(getattr(f, "compiles", 0) for f in self.stage_fns)

    def stats(self) -> ExecutorStats:
        return self._stats

    def reset_stats(self) -> None:
        with self._lock:
            self._stats = ExecutorStats(per_stage=self._fresh_counters())

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._occupancy

    # -- internals ----------------------------------------------------------- #
    def _group_tokens(self, toks: list[tuple]) -> Iterable[list[tuple]]:
        """Split the stream into runs of shape-compatible tokens (<= mb)."""
        if self.microbatch <= 1:
            for t in toks:
                yield [t]
            return
        cur: list[tuple] = []
        cur_sig: tuple | None = None
        for t in toks:
            sig = _sig_of(t)
            if cur and (sig != cur_sig or len(cur) >= self.microbatch):
                yield cur
                cur = []
            cur.append(t)
            cur_sig = sig
        if cur:
            yield cur

    def _env_of(self, args: Sequence[Any]) -> dict:
        if len(args) != len(self.graph_inputs):
            raise ValueError(f"expected {len(self.graph_inputs)} inputs, "
                             f"got {len(args)}")
        return dict(zip(self.graph_inputs, args))

    def _out_of(self, env: dict):
        outs = tuple(env[o] for o in self.graph_outputs)
        return outs[0] if len(outs) == 1 else outs

    def _stage_fns_for(self, size: int) -> list[Callable]:
        if size == 1:
            return self.stage_fns
        if self._batched_fns is None:
            from .pipeline import batched_stage_fn
            self._batched_fns = [batched_stage_fn(f) for f in self.stage_fns]
        return self._batched_fns

    def _pad_for(self, size: int) -> int:
        """Padding rows for a ragged group: to the smallest bucket that
        fits (bucketed mode) or all the way to ``microbatch``.

        ``microbatch`` itself is always the explicit final bucket (the
        constructor appends it), so every padded size lands on a shape
        ``warmup`` ran; a size no bucket fits — only reachable by bypassing
        ``_group_tokens``'s microbatch cap — is an error.  Singleton groups
        are never padded: padding one real row up to a bucket would only
        buy a stack/unstack round-trip plus wasted padded compute.
        """
        if not self.pad_microbatches or size >= self.microbatch \
                or size == 1:
            return 0
        if self.buckets:
            for b in self.buckets:
                if b >= size:
                    return b - size
            raise RuntimeError(
                f"group size {size} exceeds every pad bucket "
                f"{self.buckets}; grouping should cap at microbatch="
                f"{self.microbatch}")
        return self.microbatch - size

    def _admit(self, group_toks: list[tuple]) -> list[PendingToken]:
        size = len(group_toks)
        pad = self._pad_for(size)
        stacked = size > 1 or pad > 0
        if stacked:
            # padding rows repeat the last token, so every group of a
            # bucket has the same [bucket, ...] shapes
            rows = group_toks + [group_toks[-1]] * pad
            args = tuple(_stack(c) for c in zip(*rows))
        else:
            args = group_toks[0]
        env = self._env_of(args)

        # 1) reserve a pool slot.  The group is published with env=None and
        #    its per-group lock held, so finalizers queue on g.lock until
        #    issue completes — the executor lock itself is only held for
        #    O(us) bookkeeping, never across a stage call.
        g = _Group(None, size, stacked)
        g.lock.acquire()
        while True:
            with self._lock:
                if self.closed:
                    # close() won the race: refuse admission instead of
                    # parking tokens in rings whose workers are exiting
                    g.lock.release()
                    raise ExecutorClosed(
                        "executor closed while waiting for pool capacity")
                if not self._inflight or self._occupancy + size <= self.pool:
                    self._inflight.append(g)
                    if self._rings is not None:
                        # seq assigned under the SAME lock as the in-order
                        # deque append: retirement order == seq order
                        g.seq = self._seq
                        self._seq += 1
                    self._occupancy += size
                    self._stats.tokens_admitted += size
                    self._stats.groups_admitted += 1
                    self._stats.max_in_flight_seen = max(
                        self._stats.max_in_flight_seen, self._occupancy)
                    self._stats.occupancy_samples += 1
                    self._stats.occupancy_sum += self._occupancy
                    break
                oldest = self._inflight[0]
            # backpressure: pool full — retire the oldest group.  The device
            # wait happens OUTSIDE self._lock so concurrent retirers
            # (serving threads) never stall admission behind it.
            self._finalize(oldest)

        # 2) issue every stage outside the executor lock
        try:
            fns = self._stage_fns_for(size + pad if stacked else 1)
            counters = []
            if self._rings is not None:
                t0 = time.perf_counter()
                g.env = env
                g.fns = tuple(fns)
                g.evt = threading.Event()
                self._route(0, g.seq, g)
                enq = (time.perf_counter() - t0) * 1e3 / max(len(fns), 1)
                counters = [(si, enq) for si in range(len(fns))]
            elif self._pools is not None:
                t0 = time.perf_counter()
                self._issue_threaded(g, env, fns)
                enq = (time.perf_counter() - t0) * 1e3 / max(len(fns), 1)
                counters = [(si, enq) for si in range(len(fns))]
            else:
                # async issue; a sampled group on the card brackets each
                # stage with CUDA events, read at retirement (no host
                # wait).  On the CPU a stage has run when its call returns,
                # so the host clock around it is the sample.
                sample = self.profiler is not None and self.profiler.tick()
                dev = _cuda_device(env) if sample else None
                for si, fn in enumerate(fns):
                    if self._injector is not None:
                        # unreplicated path: injected faults error the
                        # group at issue time (no replica to retry on)
                        self._injector.on_stage_call(si)
                    start = _event(dev) if dev is not None else None
                    t0 = time.perf_counter()
                    env = fn(env)   # returns once the launches are queued
                    ms = (time.perf_counter() - t0) * 1e3
                    counters.append((si, ms))
                    if start is not None:
                        g.samples.append((si, start, _event(dev)))
                    elif sample:
                        self.profiler.record(si, ms)
                        with self._lock:
                            self._stats.per_stage[si].exec_ms += ms
                g.env = env
        except BaseException as e:
            # unwind the reservation so the failed group neither blocks the
            # pool nor surfaces bogus results
            g.error = e
            g.done = True
            with self._lock:
                self._occupancy -= g.size
                self._stats.tokens_admitted -= g.size
                self._stats.groups_admitted -= 1
                try:
                    self._inflight.remove(g)
                except ValueError:
                    pass
            if self._rings is not None and g.seq is not None \
                    and g.evt is None:
                # the seq was reserved but never routed: push the poisoned
                # group through anyway so replica rings (which consume owned
                # seqs strictly in order) never stall on a gap
                g.evt = threading.Event()
                self._route(0, g.seq, g)
            raise
        finally:
            g.lock.release()
        with self._lock:
            for si, ms in counters:
                c = self._stats.per_stage[si]
                c.issued += 1
                c.tokens += size
                c.issue_ms += ms
        return [PendingToken(self, g, i) for i in range(size)]

    # -- replicated-stage dataflow (sequence-numbered rings) ----------------- #
    def _route(self, si: int, seq: int, g: _Group) -> None:
        """Hand a group to stage ``si``'s owning replica ring.

        Ownership is looked up through ``self._owner`` (residue ``seq mod
        r`` -> replica index) under the stage's route lock, so a
        concurrent quarantine either sees this put in the old ring (and
        re-routes it during its drain) or this put sees the new owner.
        A refused hand-off (ring already closed — only reachable if a
        caller bypasses the admission-side closed check) poisons the group
        and signals its completion event, so finalizers raise instead of
        waiting forever on a worker that already exited.
        """
        r = self.replicas[si]
        with self._route_locks[si]:
            ok = self._rings[si][self._owner[si][seq % r]].put(seq, g)
        if not ok:
            if g.error is None:
                g.error = ExecutorClosed(
                    f"stage {si} ring closed before seq {seq} arrived")
            g.evt.set()

    def _replica_loop(self, si: int, w: int) -> None:
        """Worker loop for replica ``w`` of stage ``si``.

        Pops this replica's owned seqs in order, stages the group onto
        this replica's pinned device (when one is assigned), runs the
        stage to completion (blocking on device work), and routes the
        group to the next stage's owning replica — or signals completion
        after the last stage.  An errored group is forwarded without
        executing further stages, so downstream replicas never stall on a
        skipped seq.
        """
        ring = self._rings[si][w]
        last = si == len(self.stage_fns) - 1
        dev = (self._replica_devs[si][w]
               if self._replica_devs is not None else None)
        # profiler attribution must describe placements actually in effect:
        # in degraded mode (single/planning-only inventory) nothing is
        # staged, so samples carry no device ordinal
        ordinal = (self.devices[si][w]
                   if self._replica_devs is not None else None)
        # fault injection keys on the CONFIGURED placement even in degraded
        # mode: a planning-only inventory still scripts "lose ordinal 2",
        # and the replica the plan pinned there must observe the loss
        inj_ord = (self.devices[si][w]
                   if self.devices is not None else None)
        while True:
            item = ring.pop()
            if item is None:
                return
            seq, g = item
            forward = True
            if g.error is None:
                forward = self._exec_replicated(si, w, seq, g, dev,
                                                ordinal, inj_ord)
            if forward:
                if last:
                    g.evt.set()
                else:
                    self._route(si + 1, seq, g)
            else:
                return      # this replica quarantined itself; seq re-runs

    def _exec_replicated(self, si: int, w: int, seq: int, g: _Group,
                         dev: Any, ordinal: int | None,
                         inj_ord: int | None) -> bool:
        """Run stage ``si`` on group ``g`` with bounded retry.

        Injection fires BEFORE the stage body, so a retried injected fault
        never re-runs a stage that already wrote part of its output.
        Returns True when the
        group should be forwarded (success, or a non-retryable error
        recorded on the group); False when this replica quarantined itself
        — the group then re-runs on a sibling replica via the ownership
        transfer in :meth:`_quarantine`.
        """
        while True:
            t0 = time.perf_counter()
            try:
                if self._injector is not None:
                    self._injector.on_stage_call(si, replica=w,
                                                 device=inj_ord)
                if dev is not None:
                    # stage the group onto this replica's card; the stage
                    # then runs there, behind the copy on that card's stream
                    g.env = {k: (v.to(dev, non_blocking=True)
                                 if isinstance(v, torch.Tensor) else v)
                             for k, v in g.env.items()}
                    xfer = (time.perf_counter() - t0) * 1e3
                else:
                    xfer = 0.0
                g.env = g.fns[si](g.env)
                _wait(g.env)
                ms = (time.perf_counter() - t0) * 1e3
                if self.profiler is not None:
                    # the profiler measures SERVICE time — staging
                    # included, matching the replicated_bottleneck_ms
                    # contract that hand-off overhead lives in the
                    # measured stage time
                    self.profiler.record(si, ms, replica=w,
                                         device=ordinal)
                with self._lock:
                    # counters are DISJOINT: exec_ms is the stage body
                    # alone, xfer_ms the staging hop (sum = service)
                    self._stats.per_stage[si].exec_ms += ms - xfer
                    self._stats.per_stage[si].xfer_ms += xfer
                return True
            except BaseException as e:
                action = self._on_stage_error(si, w, g, e, inj_ord)
                if action == "retry":
                    continue
                if action == "quarantine":
                    self._quarantine(si, w, seq, g)
                    return False
                g.error = e
                return True

    def _on_stage_error(self, si: int, w: int, g: _Group, e: BaseException,
                        inj_ord: int | None) -> str:
        """Decide what a failed stage call on a replicated stage means.

        ``"fail"`` — record the error on the group (unreplicated stage,
        retry budget exhausted, or no healthy sibling would remain);
        ``"retry"`` — re-run locally (transient, replica still healthy);
        ``"quarantine"`` — evict this replica and re-run on a sibling.
        """
        now = time.perf_counter()
        with self._lock:
            self._stats.per_stage[si].errors += 1
            if inj_ord is not None:
                self._stats.device_errors[inj_ord] = \
                    self._stats.device_errors.get(inj_ord, 0) + 1
            self._err_counts[si][w] += 1
            errs = self._err_counts[si][w]
            healthy_others = sum(self._healthy[si]) \
                - (1 if self._healthy[si][w] else 0)
            budget_ok = self.retry_budget_ms is None \
                or (now - g.t_admit) * 1e3 < self.retry_budget_ms
            can_retry = (self.replicas[si] > 1
                         and g.retries < self.max_group_retries
                         and budget_ok)
            if can_retry:
                g.retries += 1
                self._stats.retries += 1
        if self.profiler is not None:
            # profiler has its own lock — record outside self._lock
            self.profiler.record_error(si, replica=w, device=inj_ord)
        if not can_retry:
            return "fail"
        if errs >= self.quarantine_after and healthy_others >= 1:
            return "quarantine"
        return "retry"

    def _quarantine(self, si: int, w: int, seq: int, g: _Group) -> None:
        """Evict replica ``w`` of stage ``si`` and redistribute its work.

        The failing replica drains its own ring (``retire``), rolls the
        failed seq's residue watermark back so the group re-runs, then
        hands every owned residue — and every parked group — to the
        surviving healthy replicas round-robin.  The stage's route lock
        serializes this against concurrent :meth:`_route` puts: a put
        either landed in the old ring before ``retire`` (captured and
        re-put below) or resolves the new owner afterwards.  Callers
        guarantee at least one healthy sibling remains
        (:meth:`_on_stage_error` checks ``healthy_others >= 1``).
        """
        r = self.replicas[si]
        with self._route_locks[si]:
            with self._lock:
                self._healthy[si][w] = False
                self._stats.quarantined += 1
                self._stats.quarantined_replicas.append((si, w))
                targets = [i for i in range(r) if self._healthy[si][i]]
            slots, nxt = self._rings[si][w].retire()
            # roll back the failed seq's watermark: the group whose call
            # failed must re-run on its new owner
            nxt[seq % r] = seq
            slots[seq] = g
            for j, res in enumerate(sorted(nxt)):
                t = targets[j % len(targets)]
                self._owner[si][res] = t
                self._rings[si][t].adopt(res, nxt[res])
            for s in sorted(slots):
                self._rings[si][self._owner[si][s % r]].put(s, slots[s])

    def healthy_replicas(self) -> list[int] | None:
        """Healthy worker count per stage (None for a non-replicated
        executor) — the serving layer's view of quarantine attrition."""
        if self._healthy is None:
            return None
        with self._lock:
            return [sum(h) for h in self._healthy]

    def _issue_threaded(self, g: _Group, env: dict,
                        fns: Sequence[Callable]) -> None:
        """Chain the group's stages across the serial per-stage workers.

        Stage ``s``'s task waits on stage ``s-1``'s future, runs the stage
        to completion (blocking on its device work), and returns the next
        env.  Submission order per pool preserves per-stage token order.
        """
        prev: Future | None = None
        for si, (fn, pool) in enumerate(zip(fns, self._pools)):
            prev = pool.submit(self._run_stage, fn, si,
                               env if prev is None else None, prev)
        g.future = prev

    def _run_stage(self, fn: Callable, si: int, env0: dict | None,
                   prev: Future | None) -> dict:
        env = env0 if prev is None else prev.result()
        if self._injector is not None:
            # non-replicated stage: an injected fault errors the group
            # (no sibling to retry on), same as a real stage exception
            self._injector.on_stage_call(si)
        t0 = time.perf_counter()
        out = fn(env)
        _wait(out)
        ms = (time.perf_counter() - t0) * 1e3
        if self.profiler is not None:
            self.profiler.record(si, ms)
        with self._lock:
            self._stats.per_stage[si].exec_ms += ms
        return out

    def _retire_through(self, group: _Group) -> None:
        """Finalize ``group`` and everything older (in-order retirement)."""
        while not group.done:
            with self._lock:
                if group.done or not self._inflight:
                    break
                oldest = self._inflight[0]
            self._finalize(oldest)

    def _finalize(self, g: _Group) -> None:
        """Block on a group's final outputs and unstack them.

        Idempotent; callable from any thread.  The executor lock is NOT
        held across the device wait — only the per-group lock serializes
        double-finalization, so admission can proceed while a serving
        thread blocks here.
        """
        finalized_here = False
        with g.lock:
            if not g.done:
                try:
                    if g.evt is not None:         # replicated stage workers
                        g.evt.wait()
                        if g.error is not None:
                            raise g.error
                    elif g.future is not None:    # threaded stage workers
                        g.env = g.future.result()
                    out = self._out_of(g.env)
                    _wait(out)
                    for si, a, b in g.samples:
                        ms = a.elapsed_time(b)
                        if self.profiler is not None:
                            self.profiler.record(si, ms)
                        with self._lock:
                            self._stats.per_stage[si].exec_ms += ms
                    if g.stacked:
                        if isinstance(out, tuple):
                            g.results = [tuple(o[i] for o in out)
                                         for i in range(g.size)]
                        else:
                            g.results = [out[i] for i in range(g.size)]
                    else:
                        g.results = [out]
                except BaseException as e:
                    # an execute-time failure (threaded stage, or a runtime
                    # error surfacing at the blocking wait): the group still
                    # leaves the pipeline — it counts as retired so
                    # issued == retired holds and the pool slot is freed —
                    # and every PendingToken.result() re-raises the error.
                    g.error = e
                g.done = True
                finalized_here = True
        with self._lock:
            if finalized_here:           # exactly-once accounting per group
                self._stats.tokens_retired += g.size
                if g.error is not None:
                    self._stats.tokens_failed += g.size
                self._occupancy -= g.size
                if g.seq is not None:
                    # reorder-buffer audit: retirement must consume seqs
                    # monotonically even when replicas complete out of order
                    if g.seq < self._next_retire_seq:
                        self._stats.out_of_order_retired += 1
                    self._next_retire_seq = max(self._next_retire_seq,
                                                g.seq + 1)
            # drop retired groups from the head (in-order by design)
            while self._inflight and self._inflight[0].done:
                self._inflight.popleft()
