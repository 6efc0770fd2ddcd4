"""Stage partitioning — paper Sect. III-B.4, plus a beyond-paper optimum.

The paper's policy, quoted: *"Pipeline Generator divides total processing
time by the number of thread plus one and searches the closest sub-total of
processing time of functions."*  Stages are contiguous runs of the traced
chronological order; the first and last stage run ``serial_in_order`` and the
middle stages ``parallel`` (TBB filter kinds).

Two partitioners:

* :func:`partition_paper` — the policy verbatim (paper-faithful baseline).
* :func:`partition_optimal` — beyond-paper: the contiguous-partition DP that
  *minimizes the bottleneck stage*, optionally charging each stage boundary
  its intermediate-data transfer cost.

Plus :func:`fuse_adjacent_hw` — the ``#pragma HLS dataflow`` analog: merge
maximal runs of adjacent database-hit functions with no branch, keeping the
paper's observed behavior that a fusion estimated slower than its pipelined
parts is rejected.  On the H100 the fusion gate reckons the tile the fused
kernel itself keeps in one block's shared memory (:func:`working_set_bytes`:
K4's 2-D stencil tile with its halo, K6's GEMM slices, as each fused module
declares), against the 232,448 B a block can have — not a TPU row slab
against VMEM.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Callable, Iterable, Sequence

from .costmodel import (FUSED_HALO, FUSED_TILE, SMEM_BYTES, FusionEstimate,
                        NodeCost, fused_cost, replicated_bottleneck_ms,
                        transfer_ms)
from .database import ModuleDatabase
from .ir import ITEMSIZE, CourierIR, Node
from .placement import DeviceInventory, Placement, resolve_worker_budget

__all__ = [
    "StagePlan", "PipelinePlan",
    "partition_paper", "partition_optimal", "fuse_adjacent_hw",
    "fused_working_set_bytes", "working_set_bytes", "stencil_tile_bytes",
    "kernel_tile", "make_model_fused_cost", "split_fused_node",
    "assign_replicas", "assign_stage_devices", "clear_stage_devices",
    "widen_for_deployment",
]


@dataclass
class StagePlan:  # lint: allow-mutable(mutated in place by assign_replicas / assign_stage_devices / clear_stage_devices)
    node_names: list[str]
    est_time_ms: float
    kind: str = "parallel"            # "serial_in_order" | "parallel" (TBB)
    placements: list[Placement] = field(default_factory=list)  # per node
    comm_in_bytes: int = 0            # intermediate data entering this stage
    replicas: int = 1                 # worker threads (TBB parallel filter)
    # per-replica device assignment (ordinals into the planner's
    # DeviceInventory; empty = unpinned, every replica on the default
    # device — the single-host degenerate case)
    devices: list[int] = field(default_factory=list)
    # per-replica relative throughput (parallel to ``devices``; empty =
    # homogeneous at the class baseline)
    device_speeds: list[float] = field(default_factory=list)
    # transfer cost charged when this stage's device set differs from its
    # predecessor's (host<->device staging of comm_in_bytes per token)
    xfer_in_ms: float = 0.0


@dataclass
class PipelinePlan:  # lint: allow-mutable(stages re-widened/re-pinned in place across replans)
    stages: list[StagePlan]
    policy: str = "paper"

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def bottleneck_ms(self) -> float:
        """Slowest stage's one-worker service time (replication ignored)."""
        return max(s.est_time_ms for s in self.stages)

    @property
    def replicas(self) -> list[int]:
        return [s.replicas for s in self.stages]

    @property
    def total_workers(self) -> int:
        return sum(s.replicas for s in self.stages)

    @property
    def stage_devices(self) -> list[list[int]] | None:
        """Per-stage per-replica device ordinals; None when unpinned."""
        if not any(s.devices for s in self.stages):
            return None
        return [list(s.devices) for s in self.stages]

    @property
    def effective_bottleneck_ms(self) -> float:
        """Predicted token period with stage replication applied.

        A stage ``r`` workers wide retires a token every ``t / r`` ms in
        steady state, so the period is ``max_k t_k / r_k`` — equal to
        :attr:`bottleneck_ms` for an all-serial plan.  Device-pinned plans
        additionally charge each stage its cross-device boundary transfer
        (``xfer_in_ms``) and weight replicas by their device speed.
        """
        speeds = None
        if any(s.device_speeds for s in self.stages):
            speeds = [list(s.device_speeds) for s in self.stages]
        return replicated_bottleneck_ms(
            [s.est_time_ms + s.xfer_in_ms for s in self.stages],
            self.replicas, speeds)

    def predicted_speedup(self, n_tokens: int = 1000) -> float:
        """Sequential time vs pipelined time for a long token stream.

        Pipeline time for T tokens = fill (sum of stages for token 0) +
        (T-1) * bottleneck; sequential = T * sum.  Replicated stages use
        their effective (widened) period.
        """
        total = sum(s.est_time_ms for s in self.stages)
        pipe = total + (n_tokens - 1) * self.effective_bottleneck_ms
        return (n_tokens * total) / pipe

    def describe(self) -> str:
        rows = [f"PipelinePlan[{self.policy}] {self.n_stages} stages, "
                f"bottleneck={self.effective_bottleneck_ms:.2f} ms, "
                f"steady-state speedup={self.predicted_speedup():.2f}x"]
        for i, s in enumerate(self.stages):
            width = f" x{s.replicas}" if s.replicas > 1 else ""
            devs = f" on devices {s.devices}" if s.devices else ""
            xfer = f" (+{s.xfer_in_ms:.2f} ms xfer)" if s.xfer_in_ms else ""
            rows.append(f"  Stage #{i} [{s.kind:>15s}]{width}{devs} "
                        f"{s.est_time_ms:8.2f} ms{xfer}  "
                        f"{list(zip(s.node_names, s.placements))}")
        return "\n".join(rows)

    # -- (de)serialization — verifier CLI / plan artifacts ------------------ #
    def to_json(self) -> str:
        return json.dumps({
            "policy": self.policy,
            "stages": [asdict(s) for s in self.stages],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "PipelinePlan":
        d = json.loads(s)
        stages = []
        for sd in d["stages"]:
            sd = dict(sd)
            sd["placements"] = [Placement.parse(p)
                                for p in sd.get("placements", [])]
            stages.append(StagePlan(**sd))
        return cls(stages=stages, policy=d.get("policy", "paper"))


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def _times(ir: CourierIR) -> list[float]:
    ts = []
    for n in ir.nodes:
        if n.time_ms is None:
            raise ValueError(f"node {n.name} has no processing time; run the "
                             "Frontend profile or CostModel.annotate first")
        ts.append(float(n.time_ms))
    return ts


def _mk_plan(ir: CourierIR, cuts: Sequence[int], policy: str) -> PipelinePlan:
    """``cuts`` are indices where a new stage begins (excluding 0)."""
    bounds = [0, *cuts, len(ir.nodes)]
    stages: list[StagePlan] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        nodes = ir.nodes[a:b]
        comm = 0
        for inp in nodes[0].inputs:
            v = ir.values[inp]
            if v.producer is not None:      # intermediate data via ext. memory
                comm += v.nbytes
        stages.append(StagePlan(
            node_names=[n.name for n in nodes],
            est_time_ms=sum(n.time_ms for n in nodes),
            placements=[n.placement for n in nodes],
            comm_in_bytes=comm))
    if stages:
        stages[0].kind = "serial_in_order"       # paper: first ...
        stages[-1].kind = "serial_in_order"      # ... and last are serial
        for s in stages[1:-1]:
            s.kind = "parallel"
    return PipelinePlan(stages=stages, policy=policy)


# --------------------------------------------------------------------------- #
# Paper-faithful policy
# --------------------------------------------------------------------------- #
def partition_paper(ir: CourierIR, n_threads: int = 2) -> PipelinePlan:
    """The paper's closest-subtotal policy, verbatim.

    target = total / (n_threads + 1).  Walk the chronological function list
    accumulating time; place a cut at the prefix whose subtotal is closest
    to the target (choosing between stopping before/after the element that
    crosses it), then restart the accumulation.
    """
    times = _times(ir)
    n = len(times)
    target = sum(times) / (n_threads + 1)
    cuts: list[int] = []
    acc = 0.0
    for i, t in enumerate(times[:-1]):          # never cut after the last node
        take = acc + t
        # closest sub-total: cut *after* i if take is closer to target than
        # continuing to take+next would be.
        nxt = take + times[i + 1]
        if abs(take - target) <= abs(nxt - target):
            cuts.append(i + 1)
            acc = 0.0
        else:
            acc = take
    return _mk_plan(ir, cuts, policy="paper")


# --------------------------------------------------------------------------- #
# Beyond-paper: bottleneck-optimal contiguous partition (DP)
# --------------------------------------------------------------------------- #
def _boundary_cost(ir: CourierIR, i: int, comm_bw_bytes_per_ms: float | None) -> float:
    """Transfer cost charged when a stage starts at node index i (>0)."""
    if not comm_bw_bytes_per_ms or i == 0:
        return 0.0
    n = ir.nodes[i]
    byts = 0
    for inp in n.inputs:
        v = ir.values[inp]
        if v.producer is not None:
            byts += v.nbytes
    return byts / comm_bw_bytes_per_ms


def partition_optimal(ir: CourierIR, max_stages: int | None = None,
                      comm_bw_bytes_per_ms: float | None = None,
                      stage_overhead_ms: float = 0.0) -> PipelinePlan:
    """Minimize the bottleneck stage over all contiguous partitions.

    DP over (prefix, #stages); objective for a stage [a, b) is
    ``sum(times[a:b]) + boundary_cost(a) + stage_overhead_ms``.  Sweeps the
    stage count 1..max_stages and keeps the best bottleneck (ties → fewer
    stages, which also reduces "the communication frequency of intermediate
    data").
    """
    times = _times(ir)
    n = len(times)
    max_stages = min(max_stages or n, n)
    prefix = [0.0]
    for t in times:
        prefix.append(prefix[-1] + t)

    def seg(a: int, b: int) -> float:           # cost of stage [a, b)
        return (prefix[b] - prefix[a]
                + _boundary_cost(ir, a, comm_bw_bytes_per_ms)
                + stage_overhead_ms)

    INF = float("inf")
    best_plan: tuple[float, list[int]] | None = None
    # dp[k][i] = min over partitions of first i nodes into k stages of the
    # max stage cost; parent pointers reconstruct cuts.
    dp_prev = [seg(0, i) for i in range(n + 1)]          # k = 1
    parents: list[list[int]] = [[0] * (n + 1)]
    if best_plan is None:
        best_plan = (dp_prev[n] + 0.0, [])
    for k in range(2, max_stages + 1):
        dp_cur = [INF] * (n + 1)
        par = [0] * (n + 1)
        for i in range(k, n + 1):
            for j in range(k - 1, i):
                c = max(dp_prev[j], seg(j, i))
                if c < dp_cur[i]:
                    dp_cur[i], par[i] = c, j
        parents.append(par)
        if dp_cur[n] < best_plan[0] - 1e-12:
            cuts: list[int] = []
            i, kk = n, k
            pars = parents
            while kk > 1:
                j = pars[kk - 1][i]
                cuts.append(j)
                i, kk = j, kk - 1
            best_plan = (dp_cur[n], sorted(cuts))
        dp_prev = dp_cur
    return _mk_plan(ir, best_plan[1], policy="optimal-dp")


# --------------------------------------------------------------------------- #
# Stage replication — widen the bottleneck stage (TBB parallel filters)
# --------------------------------------------------------------------------- #
def assign_replicas(plan: PipelinePlan, ir: CourierIR | None = None, *,
                    worker_budget: "int | str | None" = None,
                    inventory: DeviceInventory | None = None,
                    target_ms: float | None = None,
                    max_replicas: int | None = None) -> PipelinePlan:
    """Pick per-stage replication factors under a total worker budget.

    The widening rule (documented in EXPERIMENTS.md): every replicable
    stage gets ``ceil(stage_ms / target_ms)`` workers, clamped to
    ``[1, max_replicas]`` and to the budget.  ``target_ms`` — the token
    period the plan is widened toward — defaults to the *smallest
    achievable* period: the least candidate ``T`` (searched over
    ``{stage_ms / j}`` and the serial floor) whose total worker demand
    fits ``worker_budget``, floored by the slowest non-replicable stage
    (no budget can widen past it).

    ``worker_budget`` may be an explicit int (the override),
    :data:`~repro_torch.core.placement.AUTO_BUDGET` (the ``os.cpu_count()``
    governor), or ``None`` — which derives the budget from ``inventory``
    when one is given and raises otherwise.  ``inventory``
    (a :class:`~repro_torch.core.placement.DeviceInventory`) additionally maps
    each replica onto a concrete device via
    :func:`assign_stage_devices`: the N replicas of a widened stage are
    pinned to N distinct chips/cores and cross-device stage boundaries
    are charged their transfer cost.

    A stage is replicable only when every node in it is side-effect safe
    (``Node.serial_only`` unset); pass ``ir`` to enforce the markers —
    without it every stage is assumed pure (true for traced tensor
    pipelines).  If the explicit ``target_ms`` demands more workers than
    the budget allows, replicas are taken back from the stages whose
    effective time suffers least, so the result always satisfies
    ``sum(plan.replicas) <= worker_budget``.

    Mutates (and returns) ``plan``: only the stages' ``replicas`` (and
    device-assignment) fields change; boundaries, times, and kinds are
    untouched, which is what lets the executor reuse every compiled
    StageFn when the re-planner chooses widening over re-balancing.
    """
    times = [float(s.est_time_ms) for s in plan.stages]
    n = len(times)
    if n == 0:
        return plan
    worker_budget = resolve_worker_budget(worker_budget, n, inventory)
    if worker_budget is None:
        raise ValueError("assign_replicas needs a worker_budget (or an "
                         "inventory to derive one from)")
    if worker_budget < n:
        raise ValueError(f"worker_budget {worker_budget} below the one-"
                         f"worker-per-stage floor ({n} stages)")
    replicable = []
    for s in plan.stages:
        ok = True
        if ir is not None:
            # stateful nodes are serial even if a hand-built IR forgot the
            # flag: concurrent workers would race the slot-pool writes
            ok = not any(ir.node(nn).serial_only
                         or getattr(ir.node(nn), "state", None)
                         for nn in s.node_names)
        replicable.append(ok)
    cap = max(1, min(max_replicas if max_replicas is not None
                     else worker_budget, worker_budget - (n - 1)))

    def demand(t: float) -> list[int]:
        """Workers per stage to hit a token period of ``t``."""
        out = []
        for ms, ok in zip(times, replicable):
            if not ok or ms <= 0.0 or t <= 0.0:
                out.append(1)
            else:
                out.append(min(cap, max(1, math.ceil(ms / t - 1e-9))))
        return out

    if target_ms is None:
        # the serial floor: no widening beats the slowest serial-only stage
        floor = max((t for t, ok in zip(times, replicable) if not ok),
                    default=0.0)
        cands = sorted({max(t / j, floor)
                        for t, ok in zip(times, replicable) if t > 0
                        for j in range(1, (cap if ok else 1) + 1)} | {floor})
        target_ms = max(times)
        for t in cands:
            if t > 0 and sum(demand(t)) <= worker_budget:
                target_ms = t
                break
    reps = demand(target_ms)
    # an explicit target can over-subscribe the budget: shed replicas where
    # the effective stage time grows least
    while sum(reps) > worker_budget:
        k = min((i for i in range(n) if reps[i] > 1),
                key=lambda i: times[i] / (reps[i] - 1))
        reps[k] -= 1
    for s, r in zip(plan.stages, reps):
        s.replicas = int(r)
    if inventory is not None:
        assign_stage_devices(plan, inventory, ir=ir)
    else:
        # mutate-and-rerun API: a previous device-assigned run must not
        # leave stale per-replica pinnings behind (their lengths would no
        # longer match the new replica counts)
        clear_stage_devices(plan)
    return plan


def clear_stage_devices(plan: PipelinePlan) -> PipelinePlan:
    """Drop per-replica device pinnings (and their transfer charges).

    Callers use this when a device-assigned plan ends up deployed
    *unpinned* (no stage widened, so the executor runs on the default
    device): keeping the pinnings would charge ``effective_bottleneck_ms``
    transfer costs the executor never pays, skewing replan comparisons.
    """
    for s in plan.stages:
        s.devices = []
        s.device_speeds = []
        s.xfer_in_ms = 0.0
    return plan


def widen_for_deployment(plan: PipelinePlan, ir: CourierIR | None = None, *,
                         worker_budget: "int | str | None" = None,
                         inventory: DeviceInventory | None = None,
                         ) -> "tuple[list[int] | None, list[list[int]] | None]":
    """The widening pass as every deployment site must apply it.

    Resolves the budget (:func:`~repro_torch.core.placement.
    resolve_worker_budget`), runs :func:`assign_replicas` (device-pinned
    when an ``inventory`` is given), and returns the ``(replicas,
    devices)`` pair to hand the executor.  When no budget resolves or no
    stage widens it returns ``(None, None)`` **and clears any pinnings
    off the plan** — the executor then runs unpinned, and a plan that
    kept device speeds / transfer charges would feed wrong effective
    periods to the serving batcher.
    """
    wb = resolve_worker_budget(worker_budget, len(plan.stages), inventory)
    if wb is None:
        clear_stage_devices(plan)
        return None, None
    assign_replicas(plan, ir, worker_budget=wb, inventory=inventory)
    if not any(s.replicas > 1 for s in plan.stages):
        clear_stage_devices(plan)
        return None, None
    return plan.replicas, plan.stage_devices


def assign_stage_devices(plan: PipelinePlan, inventory: DeviceInventory,
                         ir: CourierIR | None = None) -> PipelinePlan:
    """Map every stage replica onto a concrete device of ``inventory``.

    Placement rule (greedy, heaviest stage first): each stage's ``r``
    replicas are pinned to the ``r`` devices that would complete the
    stage's per-replica share earliest — *distinct* devices whenever the
    inventory holds at least ``r`` (the whole point of widening onto
    hardware: N replicas on N chips), with wrap-around only when replicas
    outnumber devices.  Load is the per-device sum of assigned
    speed-normalized ``est_time_ms / replicas`` shares, so two widened
    stages spread over different chips instead of stacking onto device 0.
    Per-replica ``device_speeds`` come from the specs; a stage whose
    device set differs from its predecessor's is charged the transfer of
    its ``comm_in_bytes`` at the slower side's staging bandwidth
    (``xfer_in_ms``).  Stage 0 is charged the *graph inputs'* host-side
    staging when ``ir`` is given (every admitted group is copied to its
    device, and the first stage's inputs are often the pipeline's biggest
    tensors); without an ``ir`` the input bytes are unknown and stage 0
    stays uncharged.

    On a single-device inventory every replica lands on ordinal 0 with
    no transfer charge anywhere — the executor detects that and degrades
    to the host-thread behavior, paying no staging.  Mutates and returns
    ``plan``.
    """
    n_dev = len(inventory)
    load = [0.0] * n_dev
    order = sorted(range(len(plan.stages)),
                   key=lambda i: -float(plan.stages[i].est_time_ms))
    for i in order:
        s = plan.stages[i]
        r = max(int(s.replicas), 1)
        chosen: list[int] = []
        for j in range(r):
            pool = [d for d in range(n_dev) if d not in chosen] or \
                list(range(n_dev))
            share = float(s.est_time_ms) / r
            # load[d] is already the device's busy TIME (speed-normalized
            # at accumulation); pick the device that would finish this
            # replica's share earliest
            d = min(pool, key=lambda d: (
                load[d] + share / inventory.spec(d).speed, d))
            chosen.append(d)
            load[d] += share / inventory.spec(d).speed
        s.devices = chosen
        s.device_speeds = [float(inventory.spec(d).speed) for d in chosen]
    # boundary transfer: charged where the device set changes hands.  A
    # single-distinct-device plan degrades in the executor (no copies at
    # all), so nothing is charged anywhere.
    multi = len({d for s in plan.stages for d in s.devices}) > 1
    if plan.stages:
        s0 = plan.stages[0]
        s0.xfer_in_ms = 0.0
        if multi and ir is not None:
            # captured inputs (closure weights) are staged once at deploy,
            # not shipped per token — only true token inputs cost transfer
            cap = getattr(ir, "captured", {})
            in_bytes = sum(ir.values[v].nbytes for v in ir.graph_inputs
                           if v not in cap)
            if in_bytes > 0:
                bw = min(inventory.device_class(d).xfer_bw
                         for d in s0.devices)
                s0.xfer_in_ms = transfer_ms(in_bytes, bw)
    for a, b in zip(plan.stages[:-1], plan.stages[1:]):
        cur = set(b.devices)
        if multi and cur != set(a.devices) and b.comm_in_bytes > 0:
            bw = min(inventory.device_class(d).xfer_bw
                     for d in (cur | set(a.devices)))
            b.xfer_in_ms = transfer_ms(b.comm_in_bytes, bw)
        else:
            b.xfer_in_ms = 0.0
    return plan


# --------------------------------------------------------------------------- #
# Fusion pass — #pragma HLS dataflow analog, cost-model driven
# --------------------------------------------------------------------------- #
def _clone_ir_shell(ir: CourierIR, name: str) -> CourierIR:
    """Copy an IR's values (links cleared) and graph I/O, but no nodes; the
    caller's ``add_node`` calls re-derive producer/consumer links."""
    out = CourierIR(name)
    out.values = {k: type(v)(**{**v.__dict__, "consumers": [],
                                "producer": None})
                  for k, v in ir.values.items()}
    out.graph_inputs = list(ir.graph_inputs)
    out.graph_outputs = list(ir.graph_outputs)
    out.captured = dict(ir.captured)
    return out


def stencil_tile_bytes(ir: CourierIR, value_names: "Iterable[str]") -> int:
    """K4's tile: shared memory one block of a fused stencil kernel holds,
    one 2-D output tile plus its halo of every named value.

    A value shaped ``(rows, cols, ...)`` contributes ``min(rows, th + halo)
    x min(cols, tw + halo)`` pixels of ``prod(shape[2:])`` elements each, in
    its own element size; rank-0/1 values count whole (broadcast operands).
    The tile is the fused kernel's own (``kernels.harris.fused_tile`` at the
    paper's frame), so a full-width frame costs no more than a small one:
    the TPU kernels' full-width row slabs are what made width matter there.
    """
    th, tw = FUSED_TILE
    halo = FUSED_HALO
    total = 0
    for vn in set(value_names):
        v = ir.values[vn]
        item = ITEMSIZE[v.dtype]
        if len(v.shape) >= 2:
            per_px = math.prod(v.shape[2:])
            total += (min(v.shape[0], th + halo) * min(v.shape[1], tw + halo)
                      * per_px * item)
        else:
            total += max(v.nbytes, item)
    return total


def kernel_tile(db: ModuleDatabase | None, fn_key: str
                ) -> Callable[..., int] | None:
    """The shared-memory tile the fused module under ``fn_key`` declares
    (``ModuleEntry.smem_tile``); None when there is no such declaration."""
    e = db.lookup(fn_key) if db is not None else None
    return e.smem_tile if e is not None else None


def working_set_bytes(ir: CourierIR, value_names: "Iterable[str]",
                      tile: Callable[..., int] | None = None) -> int:
    """Shared memory one block of a fused kernel holds for the named values,
    reckoned by the kernel's own ``tile`` (default: the stencil tile,
    :func:`stencil_tile_bytes`).  Shared by the fusion-time gate
    (:func:`fused_working_set_bytes`) and the verifier's ``smem-spill``
    re-check on committed plans."""
    return (tile or stencil_tile_bytes)(ir, list(value_names))


def fused_working_set_bytes(ir: CourierIR, run: Sequence[Node],
                            tile: Callable[..., int] | None = None) -> int:
    """Shared memory a fused kernel's block needs for ``run``: its tile of
    every value the run touches (inputs, intermediates, outputs)."""
    seen: set[str] = set()
    for n in run:
        seen.update(n.inputs)
        seen.update(n.outputs)
    return working_set_bytes(ir, seen, tile)


def f32_flops(ir: CourierIR, node: Node) -> float:
    """The FLOP of ``node`` on f32 operands, from its values' dtypes: all of
    them when every floating-point input takes 4 bytes or more (the cost
    helpers' rule for a 4-byte element), else none."""
    floats = [ir.values[i].dtype for i in node.inputs
              if ir.values[i].dtype.startswith(("float", "bfloat"))]
    wide = bool(floats) and all(ITEMSIZE[d] >= 4 for d in floats)
    return float(node.flops or 0.0) if wide else 0.0


def one_peak_gate_ms(fe: FusionEstimate, run: Sequence[Node],
                     ) -> tuple[float, float]:
    """(fused ms, slowest part's ms) with every FLOP at the bf16 peak: the
    JAX package's gate, whose one peak prices the fused run and its parts
    alike.  :func:`fuse_adjacent_hw` decides on these two, so it takes the
    JAX package's decisions, and the fused node carries ``fe.fused_ms``,
    its f32-aware price.  A part's profiled time is kept and any other is
    recomputed from its flops and bytes, so the decisions match the JAX
    package's while a provider's time is ``NodeCost(flops,
    bytes_rw).time_ms()``."""
    c = fe.cost
    fused = NodeCost(flops=c.flops, bytes_rw=c.bytes_rw,
                     coll_bytes=c.coll_bytes).time_ms()
    worst = max(NodeCost(flops=n.flops or 0.0, bytes_rw=n.bytes_rw or 0.0,
                         measured_ms=(n.time_ms if n.time_source == "profile"
                                      else None)).time_ms() for n in run)
    return fused, worst


def make_model_fused_cost(ir: CourierIR, db: ModuleDatabase | None = None, *,
                          smem_bytes: int = SMEM_BYTES,
                          ) -> Callable[[list[Node]], FusionEstimate]:
    """Build the cost-model fusion estimator for ``fuse_adjacent_hw``.

    Returns a ``run -> FusionEstimate`` callable: the fused kernel's roofline
    with the intermediates' HBM write+read traffic removed, its f32 share
    (:func:`f32_flops`) timed at the f32 peak as its parts' is, gated by the
    shared-memory check of the tile the fused module declares in ``db`` (a
    spilling fusion reports ``fused_ms = inf`` and is always rejected).  A
    run containing a node without ``flops``/``bytes_rw`` annotations is
    conservatively unfusable.
    """
    def estimate(run: list[Node]) -> FusionEstimate | float:
        parts = []
        for n in run:
            if n.flops is None or n.bytes_rw is None:
                return float("inf")        # no model → don't gamble on fusion
            # a node keeps flops and bytes only (its JSON is the reference's):
            # its f32 share comes from its values' dtypes
            parts.append(NodeCost(flops=n.flops, bytes_rw=n.bytes_rw,
                                  f32_flops=f32_flops(ir, n),
                                  measured_ms=n.time_ms))
        inter = sum(ir.values[o].nbytes
                    for n in run[:-1] for o in n.outputs)
        tile = kernel_tile(db, "+".join(n.fn_key for n in run))
        ws = fused_working_set_bytes(ir, run, tile)
        return fused_cost(parts, inter, smem_required=ws,
                          smem_bytes=smem_bytes)
    return estimate


def split_fused_node(ir: CourierIR, name: str,
                     part_times_ms: Sequence[float] | None = None) -> CourierIR:
    """Undo one fusion: replace a fused node with its original parts.

    Part nodes are rebuilt from the routing metadata recorded at fusion
    time (``fused_part_inputs/outputs``, ``fused_params``).
    ``part_times_ms`` sets the parts' times (default: the fused node's time
    split evenly).  Returns a new IR; the input is not mutated.
    """
    node = ir.node(name)
    if not node.fused_from:
        raise ValueError(f"{name!r} is not a fused node")
    if not node.fused_part_inputs or not node.fused_part_outputs:
        raise ValueError(f"{name!r} carries no per-part routing metadata; "
                         "only nodes built by fuse_adjacent_hw can be split")
    keys = node.fn_key.split("+")
    n_parts = len(node.fused_from)
    if part_times_ms is None:
        t = (node.time_ms or 0.0) / n_parts
        part_times_ms = [t] * n_parts
    if len(part_times_ms) != n_parts:
        raise ValueError(f"need {n_parts} part times, got {len(part_times_ms)}")
    parts = []
    for i, pname in enumerate(node.fused_from):
        params = dict(node.fused_params[i]) if node.fused_params else {}
        kw = (list(node.fused_part_kw[i]) if node.fused_part_kw else [])
        parts.append(Node(
            name=pname, fn_key=keys[i],
            inputs=list(node.fused_part_inputs[i]),
            outputs=list(node.fused_part_outputs[i]),
            input_kw=kw,
            params=params, time_ms=float(part_times_ms[i]),
            time_source=node.time_source,
            serial_only=node.serial_only))

    out = _clone_ir_shell(ir, ir.name + "+defused")
    for n in ir.nodes:
        if n.name == name:
            for p in parts:
                out.add_node(p)
        else:
            out.add_node(n)
    out.validate()
    return out


def fuse_adjacent_hw(ir: CourierIR, db: ModuleDatabase,
                     fused_cost_ms: Callable[[list[Node]], float]
                     | str | None = None,
                     accept_threshold: float = 1.0,
                     smem_bytes: int = SMEM_BYTES) -> CourierIR:
    """Merge maximal runs of adjacent DB-hit nodes with no branch.

    A run is fusable when every node has an accelerated module and the run
    is *closed*: every non-final node's outputs are consumed only by nodes
    inside the run and are not graph outputs.  Stateful nodes never fuse.
    A fusion is accepted only when its estimated time ``<= accept_threshold
    * max(individual times)`` — the fused module must not become the new
    bottleneck, encoding the paper's rejection of their slow fused
    cvtColor+cornerHarris module.

    ``fused_cost_ms`` may be ``None`` (fuse nothing), ``"model"`` (use
    :func:`make_model_fused_cost`: accept what the roofline says wins,
    reject runs whose kernel's tile overflows shared memory), or a callable
    ``run ->
    float | FusionEstimate``; a returned estimate also annotates the fused
    node with the modeled flops / HBM bytes.
    """
    if fused_cost_ms is None:
        return ir
    if fused_cost_ms == "model":
        fused_cost_ms = make_model_fused_cost(ir, db, smem_bytes=smem_bytes)
    out = _clone_ir_shell(ir, ir.name + "+fused")

    def hw(n: Node) -> bool:
        if n.state:
            return False                # host-side slot state: never fused
        e = db.lookup(n.fn_key)
        return e is not None and e.has_hw(*[ir.values[i].shape for i in n.inputs])

    def closed_prefix(cand: list[Node]) -> bool:
        """Every non-final node's outputs stay inside ``cand`` (all their
        consumers sit in it) and are not graph outputs."""
        names = {n.name for n in cand}
        return all(
            o not in ir.graph_outputs
            and ir.values[o].consumers
            and all(c in names for c in ir.values[o].consumers)
            for n in cand[:-1] for o in n.outputs)

    i = 0
    new_nodes: list[Node] = []
    while i < len(ir.nodes):
        # grow the maximal adjacent hw span, then take the longest closed
        # prefix (>= 2) as the fusion candidate
        j = i
        while j < len(ir.nodes) and hw(ir.nodes[j]):
            j += 1
        run = [ir.nodes[i]]
        for L in range(j - i, 1, -1):
            cand = ir.nodes[i:i + L]
            if closed_prefix(cand):
                run = cand
                break
        if len(run) >= 2:
            est = fused_cost_ms(run)
            fe = est if isinstance(est, FusionEstimate) else None
            est_ms = fe.fused_ms if fe is not None else float(est)
            gate_ms, worst = est_ms, max(n.time_ms or 0.0 for n in run)
            if fe is not None and fe.fits_smem:
                gate_ms, worst = one_peak_gate_ms(fe, run)
            if gate_ms <= accept_threshold * worst:
                merged_params: dict = {}
                for n in run:
                    merged_params.update(n.params)
                # external inputs: everything the run consumes that it does
                # not itself produce, in first-use order — the fused node's
                # calling convention
                produced = {o for n in run for o in n.outputs}
                ext_inputs: list[str] = []
                for n in run:
                    for inp in n.inputs:
                        if inp not in produced and inp not in ext_inputs:
                            ext_inputs.append(inp)
                fused = Node(
                    name="+".join(n.name for n in run),
                    fn_key="+".join(n.fn_key for n in run),
                    inputs=ext_inputs,
                    outputs=list(run[-1].outputs),
                    params=merged_params, time_ms=est_ms,
                    placement=Placement.hw(),
                    fused_from=[n.name for n in run],
                    fused_input_shapes=[
                        [ir.values[i].shape for i in n.inputs] for n in run],
                    fused_params=[dict(n.params) for n in run],
                    fused_part_inputs=[list(n.inputs) for n in run],
                    fused_part_outputs=[list(n.outputs) for n in run],
                    fused_part_kw=[list(n.input_kw or [None] * len(n.inputs))
                                   for n in run],
                    serial_only=any(n.serial_only for n in run))
                if fe is not None:        # thread the modeled roofline through
                    fused.flops = fe.cost.flops
                    fused.bytes_rw = fe.cost.bytes_rw
                new_nodes.append(fused)
                i += len(run)
                continue
        new_nodes.append(run[0])
        i += 1

    for n in new_nodes:
        out.add_node(n)
    out.validate()
    return out
