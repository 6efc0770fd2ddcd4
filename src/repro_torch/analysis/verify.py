"""Static plan/IR verifier — the legality gate before a plan meets traffic.

A pass pipeline over :class:`~repro_torch.core.ir.CourierIR` +
:class:`~repro_torch.core.partition.PipelinePlan` that re-checks, on the
*committed* artifact, every invariant the planning passes are supposed to
establish: dataflow well-formedness, fused-node routing/shape consistency,
placement legality against the kernel database and device inventory,
replica-vector consistency, and the shared-memory spill gate.  The compiler-side
analogy (GCC accelerator plugins, Halide schedule legality) is deliberate —
a plan is a schedule, and a schedule gets verified before it runs.

Rules are registered with :func:`verify_rule` and each returns
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records.  ``verify_plan``
runs every applicable rule; ``check_plan`` raises
:class:`PlanVerificationError` on error-severity findings unless the
``REPRO_VERIFY=off`` escape hatch is set.

Gated call site: ``PipelineGenerator.generate`` (a fresh build).  Rule ids
are the JAX package's, except that ``vmem-spill`` becomes ``smem-spill``:
the fused kernel's tile set against one block's shared memory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from ..core.costmodel import SMEM_BYTES
from ..core.database import ModuleDatabase
from ..core.ir import CourierIR, Node
from ..core.partition import PipelinePlan, kernel_tile, working_set_bytes
from ..core.placement import DeviceInventory, Placement

from .diagnostics import (ERROR, WARNING, VERIFY_ENV, Diagnostic,
                          PlanVerificationError, verify_enabled)

__all__ = [
    "verify_plan", "check_plan", "verify_rule", "VERIFY_RULES",
    "VERIFY_ENV", "verify_enabled", "PlanVerificationError", "Diagnostic",
]


@dataclass(frozen=True)
class VerifyContext:
    """Everything a verify rule may look at.  ``db``/``inventory`` are
    optional — rules that need them no-op when absent (a planning-only
    caller can still verify dataflow without a kernel database)."""

    ir: CourierIR
    plan: PipelinePlan
    db: Optional[ModuleDatabase] = None
    inventory: Optional[DeviceInventory] = None
    smem_bytes: int = SMEM_BYTES

    def node(self, name: str) -> Optional[Node]:
        # lazy name index — rules look nodes up per stage entry, and the
        # per-replan/per-swap gates need that to stay O(1)
        index = self.__dict__.get("_index")
        if index is None:
            index = {n.name: n for n in self.ir.nodes}
            object.__setattr__(self, "_index", index)
        return index.get(name)


Rule = Callable[[VerifyContext], Iterable[Diagnostic]]

#: rule id -> rule fn, in registration (= execution) order
VERIFY_RULES: dict[str, Rule] = {}


def verify_rule(rule_id: str) -> Callable[[Rule], Rule]:
    """Register a verify pass under ``rule_id`` (its Diagnostic.rule)."""
    def deco(fn: Rule) -> Rule:
        VERIFY_RULES[rule_id] = fn
        return fn
    return deco


def _plan_nodes(ctx: VerifyContext):
    """(stage_index, stage, node_name, Node|None) over the plan's order.

    Cached on the context: seven rules walk this and the result must not
    be re-resolved per rule — the gate runs on every replan candidate."""
    cached = ctx.__dict__.get("_plan_nodes")
    if cached is None:
        cached = [(si, s, nn, ctx.node(nn))
                  for si, s in enumerate(ctx.plan.stages)
                  for nn in s.node_names]
        object.__setattr__(ctx, "_plan_nodes", cached)
    return cached


def _stage_label(si: int) -> str:
    return f"#{si}"


# --------------------------------------------------------------------------- #
# dataflow well-formedness
# --------------------------------------------------------------------------- #
@verify_rule("stage-coverage")
def _rule_stage_coverage(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Every IR node appears in exactly one stage; no phantom names."""
    out: list[Diagnostic] = []
    counts: dict[str, int] = {}
    for si, _s, nn, node in _plan_nodes(ctx):
        counts[nn] = counts.get(nn, 0) + 1
        if node is None:
            out.append(Diagnostic(
                rule="stage-coverage", stage=_stage_label(si), node=nn,
                message=f"stage names node {nn!r} which is not in the IR",
                hint="the plan was built against a different IR revision"))
    for nn, c in counts.items():
        if c > 1:
            out.append(Diagnostic(
                rule="stage-coverage", node=nn,
                message=f"node {nn!r} appears in {c} stages",
                hint="stage boundaries must partition the node list"))
    for n in ctx.ir.nodes:
        if n.name not in counts:
            out.append(Diagnostic(
                rule="stage-coverage", node=n.name,
                message=f"IR node {n.name!r} is not covered by any stage",
                hint="re-run the partitioner against this IR"))
    return out


@verify_rule("stage-order")
def _rule_stage_order(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Stage concat must equal the IR's chronological (traced) order —
    stages are contiguous runs of it, so any permutation breaks the
    executor's token routing."""
    plan_order = [nn for _si, _s, nn, _n in _plan_nodes(ctx)]
    ir_order = [n.name for n in ctx.ir.nodes]
    if sorted(plan_order) != sorted(ir_order):
        return []                  # coverage rule already owns this case
    if plan_order != ir_order:
        first = next(i for i, (a, b) in enumerate(zip(plan_order, ir_order))
                     if a != b)
        return [Diagnostic(
            rule="stage-order", node=plan_order[first],
            message=(f"stage concatenation diverges from traced order at "
                     f"position {first}: plan has {plan_order[first]!r}, "
                     f"IR has {ir_order[first]!r}"),
            hint="stages must be contiguous runs of ir.nodes order")]
    return []


@verify_rule("produced-once")
def _rule_produced_once(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Every consumed value is produced exactly once, before its use."""
    out: list[Diagnostic] = []
    produced: dict[str, int] = {v: 1 for v in ctx.ir.graph_inputs}
    for si, _s, nn, node in _plan_nodes(ctx):
        if node is None:
            continue               # coverage rule owns unknown nodes
        for inp in node.inputs:
            if inp not in ctx.ir.values:
                out.append(Diagnostic(
                    rule="produced-once", stage=_stage_label(si), node=nn,
                    message=f"{nn} reads unknown value {inp!r}"))
            elif produced.get(inp, 0) == 0:
                out.append(Diagnostic(
                    rule="produced-once", stage=_stage_label(si), node=nn,
                    message=(f"{nn} consumes {inp!r} before any producer "
                             f"runs"),
                    hint="a producer node was dropped or reordered"))
        for o in node.outputs:
            produced[o] = produced.get(o, 0) + 1
            if produced[o] > 1:
                out.append(Diagnostic(
                    rule="produced-once", stage=_stage_label(si), node=nn,
                    message=f"value {o!r} is produced {produced[o]} times"))
    return out


@verify_rule("output-missing")
def _rule_output_missing(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Graph outputs must survive planning — fusion/splitting must never
    hide a value the caller is owed."""
    produced = set(ctx.ir.graph_inputs)
    for _si, _s, _nn, node in _plan_nodes(ctx):
        if node is not None:
            produced.update(node.outputs)
    return [Diagnostic(
        rule="output-missing", node=ctx.ir.values.get(o) and
        ctx.ir.values[o].producer or None,
        message=f"graph output {o!r} is never produced by the planned nodes",
        hint="a fusion or edit dropped the producing node's output")
        for o in ctx.ir.graph_outputs if o not in produced]


@verify_rule("dangling-value")
def _rule_dangling_value(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Every producer-less value that is consumed (or owed to the caller)
    must be a graph input.

    The Frontend registers mid-trace first sightings (closure-captured
    weights) as captured graph inputs; an IR where a consumed value has no
    producer *and* no graph-input registration is the pre-fix tracer bug —
    the executor would have no way to ever feed it."""
    out: list[Diagnostic] = []
    inputs = set(ctx.ir.graph_inputs)
    for vn, v in ctx.ir.values.items():
        if v.producer is not None or vn in inputs:
            continue
        if v.consumers or vn in ctx.ir.graph_outputs:
            out.append(Diagnostic(
                rule="dangling-value", node=vn,
                message=(f"value {vn!r} has no producer and is not a graph "
                         f"input, yet is "
                         + ("consumed by " + ", ".join(v.consumers)
                            if v.consumers else "a graph output")),
                hint="a traced operand was never registered as a (captured) "
                     "graph input — retrace, or add it to ir.graph_inputs"))
    return out


# --------------------------------------------------------------------------- #
# fused-node routing + shape consistency
# --------------------------------------------------------------------------- #
@verify_rule("fused-routing")
def _rule_fused_routing(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """``fused_part_inputs/outputs`` must route every part consistently."""
    out: list[Diagnostic] = []
    for si, _s, nn, node in _plan_nodes(ctx):
        if node is None or not node.fused_from:
            continue
        stage = _stage_label(si)
        n_parts = len(node.fused_from)
        keys = node.fn_key.split("+")
        if len(keys) != n_parts:
            out.append(Diagnostic(
                rule="fused-routing", stage=stage, node=nn,
                message=(f"fn_key {node.fn_key!r} has {len(keys)} parts but "
                         f"fused_from lists {n_parts}")))
        # absent routing metadata is legal (pre-split fused nodes resolve
        # through the composed fallback); TRUNCATED metadata is corruption
        for field_name, lst in (("fused_part_inputs", node.fused_part_inputs),
                                ("fused_part_outputs",
                                 node.fused_part_outputs)):
            if lst and len(lst) != n_parts:
                out.append(Diagnostic(
                    rule="fused-routing", stage=stage, node=nn,
                    message=(f"{field_name} has {len(lst)} entries for "
                             f"{n_parts} fused parts"),
                    hint="routing metadata was truncated; the node cannot "
                         "be split or composed"))
        if (len(node.fused_part_inputs) != n_parts
                or len(node.fused_part_outputs) != n_parts):
            continue               # per-part checks need aligned lists
        internal: set[str] = set()
        for pi, (pins, pouts) in enumerate(zip(node.fused_part_inputs,
                                               node.fused_part_outputs)):
            for v in list(pins) + list(pouts):
                if v not in ctx.ir.values:
                    out.append(Diagnostic(
                        rule="fused-routing", stage=stage, node=nn,
                        message=(f"part {pi} routes unknown value {v!r}")))
            for v in pins:
                if v not in internal and v not in node.inputs:
                    out.append(Diagnostic(
                        rule="fused-routing", stage=stage, node=nn,
                        message=(f"part {pi} input {v!r} is neither an "
                                 f"external input nor produced by an "
                                 f"earlier part")))
            internal.update(pouts)
    return out


@verify_rule("shape-mismatch")
def _rule_shape_mismatch(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Shapes recorded at fusion time must match the IR's values — a drifted
    shape means the composed fallback would be called with wrong operands."""
    out: list[Diagnostic] = []
    for si, _s, nn, node in _plan_nodes(ctx):
        if node is None or not node.fused_input_shapes:
            continue
        if len(node.fused_input_shapes) != len(node.fused_part_inputs):
            continue               # fused-routing owns misaligned metadata
        for pi, (shapes, pins) in enumerate(zip(node.fused_input_shapes,
                                                node.fused_part_inputs)):
            if len(shapes) != len(pins):
                out.append(Diagnostic(
                    rule="shape-mismatch", stage=_stage_label(si), node=nn,
                    message=(f"part {pi} records {len(shapes)} input shapes "
                             f"for {len(pins)} inputs")))
                continue
            for shape, vn in zip(shapes, pins):
                v = ctx.ir.values.get(vn)
                if v is not None and tuple(shape) != tuple(v.shape):
                    out.append(Diagnostic(
                        rule="shape-mismatch", stage=_stage_label(si),
                        node=nn,
                        message=(f"part {pi} recorded shape {tuple(shape)} "
                                 f"for {vn!r} but the IR says "
                                 f"{tuple(v.shape)}"),
                        hint="the IR was edited after fusion; re-fuse"))
    return out


# --------------------------------------------------------------------------- #
# placement legality
# --------------------------------------------------------------------------- #
def _node_placement(s, idx: int, node: Node) -> Placement:
    if idx < len(s.placements):
        return Placement.parse(s.placements[idx])
    return Placement.parse(node.placement)


@verify_rule("hw-unresolvable")
def _rule_hw_unresolvable(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """hw-placed nodes must resolve in the kernel database for their
    shapes/dtypes (applicability predicates included)."""
    if ctx.db is None:
        return []
    out: list[Diagnostic] = []
    for si, s, nn, node in _plan_nodes(ctx):
        if node is None:
            continue
        p = _node_placement(s, s.node_names.index(nn), node)
        if not p.is_hw:
            continue
        stage = _stage_label(si)
        if node.fused_from:
            # a fused hw node runs either a dedicated fused module or the
            # composed parts; legal when the joined key is accelerated OR
            # every part key is at least registered
            entry = ctx.db.lookup(node.fn_key)
            if entry is not None and entry.accelerated is not None:
                continue
            missing = [k for k in node.fn_key.split("+")
                       if ctx.db.lookup(k) is None]
            if missing:
                out.append(Diagnostic(
                    rule="hw-unresolvable", stage=stage, node=nn,
                    message=(f"fused node {nn} placed hw but parts "
                             f"{missing} are not in database "
                             f"{ctx.db.name!r}"),
                    hint="register the parts or place the node sw"))
            continue
        entry = ctx.db.lookup(node.fn_key)
        if entry is None:
            out.append(Diagnostic(
                rule="hw-unresolvable", stage=stage, node=nn,
                message=(f"{nn} placed hw but fn_key {node.fn_key!r} is not "
                         f"in database {ctx.db.name!r}")))
            continue
        shapes = [tuple(ctx.ir.values[i].shape) for i in node.inputs
                  if i in ctx.ir.values]
        if not entry.has_hw(*shapes):
            out.append(Diagnostic(
                rule="hw-unresolvable", stage=stage, node=nn,
                message=(f"{nn} placed hw but {node.fn_key!r} has no "
                         f"accelerated module applicable to shapes "
                         f"{shapes}"),
                hint="the applicability predicate rejects these shapes; "
                     "place the node sw"))
    return out


@verify_rule("replica-vector")
def _rule_replica_vector(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """``replicas``/``devices``/``device_speeds`` must agree per stage."""
    out: list[Diagnostic] = []
    for si, s in enumerate(ctx.plan.stages):
        stage = _stage_label(si)
        if int(s.replicas) < 1:
            out.append(Diagnostic(
                rule="replica-vector", stage=stage,
                message=f"stage has replicas={s.replicas} (< 1)"))
        if s.devices and len(s.devices) != int(s.replicas):
            out.append(Diagnostic(
                rule="replica-vector", stage=stage,
                message=(f"{len(s.devices)} pinned devices for "
                         f"{s.replicas} replicas"),
                hint="assign_replicas/clear_stage_devices left stale "
                     "pinnings behind"))
        if s.device_speeds:
            if not s.devices:
                out.append(Diagnostic(
                    rule="replica-vector", stage=stage,
                    message="device_speeds set on an unpinned stage",
                    hint="clear_stage_devices must wipe speeds with devices"))
            elif len(s.device_speeds) != int(s.replicas):
                out.append(Diagnostic(
                    rule="replica-vector", stage=stage,
                    message=(f"{len(s.device_speeds)} device speeds for "
                             f"{s.replicas} replicas")))
            if any(not (sp > 0.0) for sp in s.device_speeds):
                out.append(Diagnostic(
                    rule="replica-vector", stage=stage,
                    message=f"non-positive device speed in "
                            f"{s.device_speeds}"))
    return out


@verify_rule("device-ordinal")
def _rule_device_ordinal(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Pinned ordinals must exist in the deployment's DeviceInventory."""
    if ctx.inventory is None:
        return []
    n = len(ctx.inventory)
    return [Diagnostic(
        rule="device-ordinal", stage=_stage_label(si),
        message=(f"device ordinal {d} out of range for a {n}-device "
                 f"inventory"),
        hint="the plan was placed against a different inventory")
        for si, s in enumerate(ctx.plan.stages)
        for d in s.devices if not (0 <= int(d) < n)]


@verify_rule("serial-only-widened")
def _rule_serial_only_widened(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """A stage holding a ``serial_only`` node must keep exactly one worker."""
    out: list[Diagnostic] = []
    for si, s in enumerate(ctx.plan.stages):
        if int(s.replicas) <= 1:
            continue
        for nn in s.node_names:
            node = ctx.node(nn)
            if node is not None and node.serial_only:
                out.append(Diagnostic(
                    rule="serial-only-widened", stage=_stage_label(si),
                    node=nn,
                    message=(f"stage widened to {s.replicas} workers but "
                             f"{nn} is serial_only"),
                    hint="assign_replicas must pass the IR so markers are "
                         "enforced"))
    return out


@verify_rule("state-slot")
def _rule_state_slot(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Stateful (slot-bound) nodes mutate host-side state per call, so
    three plan shapes are illegal for them: replicated stages (two workers
    would race on the slot arena), hw placement (the state lives host-side
    by construction), and fusion (the composed replay would run its mutation inside a fused kernel)."""
    out: list[Diagnostic] = []
    for si, s, nn, node in _plan_nodes(ctx):
        if node is None or not getattr(node, "state", None):
            continue
        stage = _stage_label(si)
        if int(s.replicas) > 1:
            out.append(Diagnostic(
                rule="state-slot", stage=stage, node=nn,
                message=(f"stateful node {nn} (state={node.state!r}) sits "
                         f"in a stage widened to {s.replicas} workers"),
                hint="stateful stages are serial_only; re-run "
                     "assign_replicas with the IR"))
        p = _node_placement(s, s.node_names.index(nn), node)
        if p.is_hw:
            out.append(Diagnostic(
                rule="state-slot", stage=stage, node=nn,
                message=(f"stateful node {nn} placed hw but its state "
                         f"{node.state!r} lives host-side"),
                hint="place the node sw; accelerate the stateless parts "
                     "around it instead"))
        if node.fused_from:
            out.append(Diagnostic(
                rule="state-slot", stage=stage, node=nn,
                message=(f"stateful node {nn} was fused "
                         f"({node.fn_key!r}) — its slot mutation cannot "
                         f"live inside a fused kernel"),
                hint="fuse_adjacent_hw must refuse stateful nodes; "
                     "split_fused_node to recover"))
    return out


@verify_rule("phantom-xfer")
def _rule_phantom_xfer(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Transfer charges are only legal on genuinely multi-device plans —
    an unpinned/degraded plan paying ``xfer_in_ms`` skews every replan
    comparison against it."""
    distinct = {d for s in ctx.plan.stages for d in s.devices}
    if len(distinct) > 1:
        return []
    return [Diagnostic(
        rule="phantom-xfer", stage=_stage_label(si),
        message=(f"stage charges xfer_in_ms={s.xfer_in_ms:.3f} but the plan "
                 f"uses {len(distinct)} distinct device(s)"),
        hint="clear_stage_devices when deploying unpinned")
        for si, s in enumerate(ctx.plan.stages) if s.xfer_in_ms > 0.0]


# --------------------------------------------------------------------------- #
# fusion legality (shared memory) + sanity
# --------------------------------------------------------------------------- #
@verify_rule("smem-spill")
def _rule_smem_spill(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Re-check the shared-memory gate on the committed plan: a fused hw
    node whose kernel's per-block tile (the one its module declares in the
    database, else one 2-D stencil tile plus halo of every value it
    touches) overflows a block's shared memory must not ship, no matter
    what the fusion-time estimate said."""
    out: list[Diagnostic] = []
    for si, s, nn, node in _plan_nodes(ctx):
        if node is None or not node.fused_from:
            continue
        p = _node_placement(s, s.node_names.index(nn), node)
        if not p.is_hw:
            continue
        names = set(node.inputs) | set(node.outputs)
        for pins in node.fused_part_inputs:
            names.update(pins)
        for pouts in node.fused_part_outputs:
            names.update(pouts)
        names &= set(ctx.ir.values)        # missing values flagged elsewhere
        ws = working_set_bytes(ctx.ir, names,
                               kernel_tile(ctx.db, node.fn_key))
        if ws > ctx.smem_bytes:
            out.append(Diagnostic(
                rule="smem-spill", stage=_stage_label(si), node=nn,
                message=(f"fused node tile set {ws} B exceeds one block's "
                         f"shared memory ({ctx.smem_bytes} B)"),
                hint="split the fusion (split_fused_node) or place it sw"))
    return out


@verify_rule("stage-time")
def _rule_stage_time(ctx: VerifyContext) -> Iterable[Diagnostic]:
    """Non-positive/non-finite stage times poison every planning decision
    downstream (warning: the executor itself would still run)."""
    return [Diagnostic(
        rule="stage-time", severity=WARNING, stage=_stage_label(si),
        message=f"stage est_time_ms={s.est_time_ms!r} is not a positive "
                f"finite number",
        hint="annotate times (CostModel.annotate / profiler) before "
             "partitioning")
        for si, s in enumerate(ctx.plan.stages)
        if not (isinstance(s.est_time_ms, (int, float))
                and math.isfinite(s.est_time_ms) and s.est_time_ms >= 0.0)]


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
def verify_plan(ir: CourierIR, plan: PipelinePlan, *,
                db: ModuleDatabase | None = None,
                inventory: DeviceInventory | None = None,
                smem_bytes: int = SMEM_BYTES) -> list[Diagnostic]:
    """Run every registered verify rule; return all findings (worst first)."""
    ctx = VerifyContext(ir=ir, plan=plan, db=db, inventory=inventory,
                        smem_bytes=smem_bytes)
    diags: list[Diagnostic] = []
    for fn in VERIFY_RULES.values():
        diags.extend(fn(ctx))
    diags.sort(key=lambda d: (d.severity != ERROR, d.rule))
    return diags


def check_plan(ir: CourierIR, plan: PipelinePlan, *,
               db: ModuleDatabase | None = None,
               inventory: DeviceInventory | None = None,
               smem_bytes: int = SMEM_BYTES,
               where: str = "check_plan") -> list[Diagnostic]:
    """The gate: verify and raise on errors (unless ``REPRO_VERIFY=off``).

    Returns the full diagnostic list (warnings included) when the plan
    passes, so callers can surface non-fatal findings.
    """
    if not verify_enabled():
        return []
    diags = verify_plan(ir, plan, db=db, inventory=inventory,
                        smem_bytes=smem_bytes)
    errors = [d for d in diags if d.severity == ERROR]
    if errors:
        raise PlanVerificationError(where, errors)
    return diags
