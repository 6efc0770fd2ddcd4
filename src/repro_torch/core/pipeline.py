"""Pipeline Generator — paper Sect. III: build & run the mixed pipeline.

Given a traced CourierIR and the module database, the generator

1. assigns placements by database lookup (hit → "hw" CUDA kernel, miss →
   "sw" plain PyTorch function) and re-estimates hit nodes with the
   database's cost estimator (the synthesis-report analog),
2. optionally fuses adjacent branch-free hw nodes (``#pragma HLS dataflow``),
3. partitions the chronological node list into balanced contiguous stages
   (paper policy or bottleneck-optimal DP),
4. gates the plan on the static verifier,
5. emits one callable per stage operating on the live-value environment at
   the stage boundary (the paper's "intermediate data ... stored in the
   external memory" — here, stage-boundary tensors in HBM),
6. wraps everything in a :class:`BuiltPipeline` whose ``run`` executes a
   TBB-style token pipeline: a wavefront schedule with a bounded number of
   in-flight tokens, first/last stages serial-in-order.

Two token-stream execution paths are exposed:

* ``BuiltPipeline.run`` — the synchronous wavefront schedule (the host
  steps every in-flight token one stage at a time); the paper-faithful
  baseline.
* ``BuiltPipeline.run_async`` / ``BuiltPipeline.executor()`` — the
  asynchronous executor (:mod:`repro_torch.core.executor`): eager stage
  issue, bounded token pool, optional per-stage micro-batching, threaded
  and replicated stages.  This is the serving path.

Stages run eagerly.  PyTorch's CUDA launches return before the card
finishes, on the current stream, so stage s can be issued for token k+1
while token k is still executing — the paper's "Task #0 can take the second
input while Task #1 is processing".  Nothing on the path reads a device value
back to the host, so the host never waits inside a stage.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Iterable, Sequence

import torch

from .costmodel import CostModel
from .database import ModuleDatabase
from .ir import CourierIR, Node
from .partition import (PipelinePlan, fuse_adjacent_hw, partition_optimal,
                        partition_paper)
from .placement import HW, SW, Placement, is_hw

if TYPE_CHECKING:                                    # pragma: no cover
    from .executor import PipelineExecutor

__all__ = ["PipelineGenerator", "BuiltPipeline", "StageFn",
           "assign_placements", "make_stage_fns", "loop_batched",
           "batched_stage_fn"]


def loop_batched(fn: Callable) -> Callable:
    """Run a stage body once per leading-axis row of its env and restack.

    The executor's micro-batching for a stage that cannot take a stacked
    group in one call (a library row without leading batch dims, such as
    the Harris kernels, whose tiles do not cross image borders): each row
    runs exactly as a single token would, in row order.
    """
    def batched(env: dict) -> dict:
        b = next(iter(env.values())).shape[0]
        outs = [fn({k: v[i] for k, v in env.items()}) for i in range(b)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    batched.__name__ = f"loop_batched_{getattr(fn, '__name__', 'stage')}"
    return batched


def batched_stage_fn(f: Callable) -> Callable:
    """The group-wide form of one stage: its raw body when every node in
    it takes leading batch dims (``StageFn.batchable``), which hands the
    stacked group to each kernel in one launch; else :func:`loop_batched`.
    It replaces the JAX package's ``jit(vmap(stage))``: ``torch.func.vmap``
    cannot see inside a kernel called through ``ctypes``."""
    raw = getattr(f, "raw", f)
    return raw if getattr(f, "batchable", False) else loop_batched(raw)


# --------------------------------------------------------------------------- #
# Step: placement assignment (database lookup)
# --------------------------------------------------------------------------- #
def assign_placements(ir: CourierIR, db: ModuleDatabase,
                      prefer_hw: bool = True) -> None:
    """Paper Fig. 3 'Search corresponding modules from a HW module DB'.

    Marks each node's backend kind and, for hw nodes with a cost estimator,
    replaces the measured software time with the estimated accelerated time
    (the paper mixes measured SW times with synthesis-estimated HW times).
    Nodes whose ``time_ms`` came from an online profile keep it.  Only the
    placement's *kind* is (re)resolved: a device/replica pinning survives.
    """
    for n in ir.nodes:
        e = db.lookup(n.fn_key)
        shapes = [ir.values[i].shape for i in n.inputs]
        cur = Placement.parse(n.placement)
        if e is not None and prefer_hw and e.has_hw(*shapes):
            n.placement = cur.with_kind(HW)
            if e.cost_hw is not None:
                dtypes = [ir.values[i].dtype for i in n.inputs]
                c = e.cost_hw(shapes, dtypes, n.params)
                n.flops, n.bytes_rw = c.flops, c.bytes_rw
                if n.time_source != "profile":
                    n.time_ms = c.time_ms()
        else:
            n.placement = cur.with_kind(SW)


# --------------------------------------------------------------------------- #
# Stage construction
# --------------------------------------------------------------------------- #
def _liveness(ir: CourierIR, plan: PipelinePlan) -> list[list[str]]:
    """Live value names at each stage boundary (len = n_stages + 1).

    boundary[0] = graph inputs; boundary[k] = values produced before stage k
    that are still needed by stages >= k or are graph outputs.  Captured
    graph inputs (closure-held constants) never cross boundaries, except a
    captured value that is a graph output, at the final boundary.
    """
    name_to_stage: dict[str, int] = {}
    for si, s in enumerate(plan.stages):
        for nn in s.node_names:
            name_to_stage[nn] = si

    cap = set(ir.captured)
    boundaries: list[list[str]] = [[v for v in ir.graph_inputs
                                    if v not in cap]]
    produced: set[str] = set(ir.graph_inputs)
    for k in range(1, plan.n_stages + 1):
        for nn in plan.stages[k - 1].node_names:
            produced.update(ir.node(nn).outputs)
        live: list[str] = []
        for v in produced:
            if v in cap and not (k == plan.n_stages
                                 and v in ir.graph_outputs):
                continue
            needed = any(
                name_to_stage.get(c, -1) >= k for c in ir.values[v].consumers
            ) or v in ir.graph_outputs
            if needed:
                live.append(v)
        boundaries.append(sorted(live))
    return boundaries


def _accepts_params(fn: Callable, params: dict) -> bool:
    """True when ``fn(*args, **params)`` cannot fail on a param name: a
    dedicated fused module is used only when it understands *every* merged
    param of the fused run."""
    if not params:
        return True
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    names = set()
    for p in sig.parameters.values():
        if p.kind == p.VAR_KEYWORD:
            return True
        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
            names.add(p.name)
    return set(params) <= names


def _resolve_impl(node: Node, ir: CourierIR, db: ModuleDatabase) -> Callable:
    if node.fused_from:
        # fused node "a+b": prefer a *dedicated* fused hw module registered
        # under the joined key (the single-pass fused kernel); fall back to
        # composing the parts' impls, re-checking each part's shape-gated
        # hw applicability against the input shapes recorded at fusion time
        shapes = [ir.values[i].shape for i in node.inputs]
        e = db.lookup(node.fn_key)
        if (e is not None and e.has_hw(*shapes)
                and _accepts_params(e.accelerated, node.params)):
            return e.accelerated
        keys = node.fn_key.split("+")
        part_shapes = node.fused_input_shapes or [[] for _ in keys]
        part_params = node.fused_params or [{} for _ in keys]
        impls = [db.resolve(k, *ps, prefer_hw=True)[0]
                 for k, ps in zip(keys, part_shapes)]

        if node.fused_part_inputs:
            # route each part exactly the values it consumed pre-fusion,
            # replaying keyword bindings under their trace-time names
            part_kws = (tuple(map(tuple, node.fused_part_kw))
                        if node.fused_part_kw
                        else tuple(tuple([None] * len(ins))
                                   for ins in node.fused_part_inputs))
            routing = tuple(zip(tuple(map(tuple, node.fused_part_inputs)),
                                tuple(map(tuple, node.fused_part_outputs)),
                                part_kws))
            arg_names = tuple(node.inputs)
            out_names = tuple(node.outputs)

            def fused(*args: Any, _impls=tuple(impls),
                      _params=tuple(part_params), **_merged: Any):
                env = dict(zip(arg_names, args))
                for (ins, outs, kws), f, pp in zip(routing, _impls, _params):
                    pos = [env[v] for v, kw in zip(ins, kws) if kw is None]
                    kw = {kw: env[v] for v, kw in zip(ins, kws)
                          if kw is not None}
                    out = f(*pos, **kw, **pp)
                    out_t = out if isinstance(out, (tuple, list)) else (out,)
                    env.update(zip(outs, out_t))
                res = tuple(env[v] for v in out_names)
                return res[0] if len(res) == 1 else res
            return fused

        def fused(*args: Any, **_merged: Any):
            # linear-chain composition (fused nodes built without routing
            # metadata, e.g. by hand)
            out = args
            for f, pp in zip(impls, part_params):
                out = f(*out, **pp)
                if not isinstance(out, (tuple, list)):
                    out = (out,)
            return out[0] if len(out) == 1 else tuple(out)
        return fused
    shapes = [ir.values[i].shape for i in node.inputs]
    fn, _ = db.resolve(node.fn_key, *shapes, prefer_hw=is_hw(node.placement))
    return fn


class StageFn:
    """One pipeline stage: ``dict(live-in) -> dict(live-out)``, run eagerly.

    The JAX package wraps each stage in a hoisted ``jax.jit`` and counts its
    compiles; PyTorch runs the body as written and launches each kernel as
    it is reached, so there is nothing to compile and :attr:`compiles` is 0.
    ``batchable`` is True when every node's library row takes leading batch
    dims, so the body accepts a micro-batched (stacked) env as it is.
    """

    __slots__ = ("raw", "batchable", "__name__")

    def __init__(self, fn: Callable, batchable: bool = False):
        self.raw = fn
        self.batchable = batchable
        self.__name__ = getattr(fn, "__name__", "stage")

    def __call__(self, env: dict) -> dict:
        return self.raw(env)

    @property
    def compiles(self) -> int:
        return 0


def _batch_dims(node: Node, db: ModuleDatabase) -> bool:
    """True when the node's database row says its implementations take
    leading batch dims (a fused node without a dedicated row: False, so its
    stage loops over the group's rows)."""
    e = db.lookup(node.fn_key)
    return e is not None and e.batch_dims


def make_stage_fns(ir: CourierIR, db: ModuleDatabase, plan: PipelinePlan,
                   cache: dict | None = None) -> list[StageFn]:
    """One callable per stage: dict(live-in) -> dict(live-out).

    ``cache``: optional dict carried across re-plans; a stage whose node
    names, placements and live-in/out boundaries are unchanged reuses the
    same :class:`StageFn`.
    """
    boundaries = _liveness(ir, plan)
    fns: list[StageFn] = []
    for k, s in enumerate(plan.stages):
        nodes = [ir.node(nn) for nn in s.node_names]
        live_out = boundaries[k + 1]
        key = (tuple(s.node_names),
               tuple(Placement.parse(n.placement).key for n in nodes),
               tuple(boundaries[k]), tuple(live_out))
        if cache is not None and key in cache:
            fns.append(cache[key])
            continue
        impls = [_resolve_impl(n, ir, db) for n in nodes]

        def stage(env: dict, _nodes=tuple(nodes), _impls=tuple(impls),
                  _live=tuple(live_out), _cap=dict(ir.captured)):
            env = dict(env)
            for node, impl in zip(_nodes, _impls):
                # captured operands come from the closure, everything else
                # from the live env; keyword-bound tensors replay under
                # their trace-time name
                kws = node.input_kw or [None] * len(node.inputs)
                pos = [env[v] if v in env else _cap[v]
                       for v, kw in zip(node.inputs, kws) if kw is None]
                kw = {kw: env[v] if v in env else _cap[v]
                      for v, kw in zip(node.inputs, kws) if kw is not None}
                out = impl(*pos, **kw, **node.params)
                outs = out if isinstance(out, (tuple, list)) else (out,)
                for name, o in zip(node.outputs, outs):
                    env[name] = o
            return {k2: env[k2] if k2 in env else _cap[k2] for k2 in _live}

        sf = StageFn(stage, batchable=all(_batch_dims(n, db) for n in nodes))
        if cache is not None:
            cache[key] = sf
        fns.append(sf)
    return fns


# --------------------------------------------------------------------------- #
# The built pipeline (deployable artifact)
# --------------------------------------------------------------------------- #
@dataclass
class BuiltPipeline:
    ir: CourierIR
    plan: PipelinePlan
    stage_fns: list[Callable]
    graph_inputs: list[str]                  # per-token inputs callers feed
    graph_outputs: list[str]
    max_in_flight: int | None = None         # TBB token-pool size
    # captured graph inputs, bound by the stage closures, never passed per
    # token — ``graph_inputs`` above already excludes them
    captured: dict[str, Any] = field(default_factory=dict)
    # the group-wide stage list, built once and shared by every executor
    # over this pipeline
    _batched_fns: list[Callable] | None = field(default=None, repr=False)

    # -- single token, through all stages (also the reference semantics) --- #
    def __call__(self, *args: Any):
        env = self._env_of(args)
        for fn in self.stage_fns:
            env = fn(env)
        return self._out_of(env)

    # -- token pipeline (paper Fig. 2) -------------------------------------- #
    def run(self, tokens: Iterable[tuple | Any]) -> list[Any]:
        """Wavefront token pipeline with a bounded token pool.

        Issues stage s for token k at wavefront step s+k; CUDA launches are
        asynchronous on the current stream, so the host issues ahead of the
        card.  ``max_in_flight`` bounds live tokens (default: n_stages + 1,
        the double-buffering minimum).
        """
        toks = [t if isinstance(t, tuple) else (t,) for t in tokens]
        n = len(toks)
        S = len(self.stage_fns)
        pool = self._validated_pool()
        envs: dict[int, Any] = {}
        done: dict[int, Any] = {}
        next_tok = 0
        at: dict[int, int] = {}              # stage index each token sits at
        while len(done) < n:
            # admit new tokens while the pool has room (serial_in_order entry)
            while next_tok < n and len(envs) < pool:
                envs[next_tok] = self._env_of(toks[next_tok])
                at[next_tok] = 0
                next_tok += 1
            # advance the *oldest* tokens first (keeps in-order completion)
            for k in sorted(envs):
                s = at[k]
                envs[k] = self.stage_fns[s](envs[k])
                at[k] = s + 1
                if at[k] == S:
                    done[k] = self._out_of(envs.pop(k))
                    at.pop(k)
        return [done[k] for k in range(n)]

    def run_sequential(self, tokens: Iterable[tuple | Any]) -> list[Any]:
        """No pipelining — the original binary's behavior (baseline)."""
        return [self(*t) if isinstance(t, tuple) else self(t) for t in tokens]

    # -- async executor (TBB parallel_pipeline analog) ---------------------- #
    def executor(self, *, max_in_flight: int | None = None,
                 microbatch: int = 1, pad_microbatches: bool = False,
                 buckets: "Sequence[int] | None" = None,
                 profiler: Any = None, stage_workers: bool = False,
                 replicas: "Sequence[int] | None" = None,
                 devices: "Sequence[Sequence[int]] | None" = None,
                 inventory: Any = None, fault_injector: Any = None,
                 max_group_retries: int = 3, quarantine_after: int = 1,
                 retry_budget_ms: float | None = None,
                 open_groups: bool = False,
                 pad_token: tuple | None = None,
                 ) -> "PipelineExecutor":
        """Build a :class:`~repro_torch.core.executor.PipelineExecutor` over
        these stages (bounded token pool, eager issue, optional per-stage
        micro-batching with bucketed ragged-group padding, threaded or
        replicated stages, fault injection with retry and quarantine,
        continuous batching at the seam with ``open_groups``/``pad_token``;
        see the executor for each argument).  ``max_in_flight`` defaults to
        this pipeline's own setting."""
        from .executor import PipelineExecutor
        return PipelineExecutor.from_pipeline(
            self, max_in_flight=max_in_flight, microbatch=microbatch,
            pad_microbatches=pad_microbatches, buckets=buckets,
            profiler=profiler, stage_workers=stage_workers,
            replicas=replicas, devices=devices, inventory=inventory,
            fault_injector=fault_injector,
            max_group_retries=max_group_retries,
            quarantine_after=quarantine_after,
            retry_budget_ms=retry_budget_ms,
            open_groups=open_groups, pad_token=pad_token)

    def run_async(self, tokens: Iterable[tuple | Any], *,
                  max_in_flight: int | None = None,
                  microbatch: int = 1) -> list[Any]:
        """Run a token stream through the asynchronous executor: every
        stage of an admitted token is issued at once, and the host blocks
        only when the token pool is full or at retirement.  Results arrive
        in submission order, equal to :meth:`run`'s."""
        ex = self.executor(max_in_flight=max_in_flight, microbatch=microbatch)
        try:
            return ex.run(tokens)
        finally:
            ex.close()

    def batched_stage_fns(self) -> list[Callable]:
        """The group-wide stage list for micro-batched execution
        (:func:`batched_stage_fn` of each stage), built once per pipeline
        and handed to every executor."""
        if self._batched_fns is None:
            self._batched_fns = [batched_stage_fn(f) for f in self.stage_fns]
        return self._batched_fns

    def compile_count(self) -> int:
        """Executables compiled for the stages: 0, since PyTorch runs them
        eagerly (the JAX package counts its jit caches here)."""
        return sum(getattr(f, "compiles", 0) for f in self.stage_fns)

    def describe(self) -> str:
        return self.plan.describe()

    # -- helpers ------------------------------------------------------------ #
    def _validated_pool(self) -> int:
        """Token-pool size; ``max_in_flight=0`` is an error, not "unset"."""
        if self.max_in_flight is not None and self.max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1 (got {self.max_in_flight}); "
                "use None for the default pool of n_stages + 1")
        S = len(self.stage_fns)
        return self.max_in_flight if self.max_in_flight is not None else S + 1

    def _env_of(self, args: Sequence[Any]) -> dict:
        if len(args) != len(self.graph_inputs):
            raise ValueError(f"expected {len(self.graph_inputs)} inputs, "
                             f"got {len(args)}")
        return dict(zip(self.graph_inputs, args))

    def _out_of(self, env: dict):
        outs = tuple(env[o] if o in env else self.captured[o]
                     for o in self.graph_outputs)
        return outs[0] if len(outs) == 1 else outs


# --------------------------------------------------------------------------- #
# The generator itself (paper Step 8)
# --------------------------------------------------------------------------- #
class PipelineGenerator:
    """End-to-end: IR + database → BuiltPipeline."""

    def __init__(self, db: ModuleDatabase, cost_model: CostModel | None = None):
        self.db = db
        self.cost_model = cost_model

    def generate(self, ir: CourierIR, n_threads: int = 2,
                 policy: str = "paper", prefer_hw: bool = True,
                 fuse: bool = False,
                 fused_cost_ms: Callable[[list[Node]], float] | None = None,
                 max_stages: int | None = None,
                 comm_bw_bytes_per_ms: float | None = None,
                 max_in_flight: int | None = None) -> BuiltPipeline:
        if self.cost_model is not None:
            self.cost_model.annotate(ir)
        assign_placements(ir, self.db, prefer_hw=prefer_hw)
        if fuse:
            # with no explicit estimator the *cost model* decides (fusions
            # whose tile set fits shared memory and whose roofline wins)
            ir = fuse_adjacent_hw(
                ir, self.db,
                fused_cost_ms=fused_cost_ms if fused_cost_ms is not None
                else "model")
            assign_placements(ir, self.db, prefer_hw=prefer_hw)
        if policy == "paper":
            plan = partition_paper(ir, n_threads=n_threads)
        elif policy == "optimal":
            plan = partition_optimal(ir, max_stages=max_stages,
                                     comm_bw_bytes_per_ms=comm_bw_bytes_per_ms)
        else:
            raise ValueError(f"unknown policy {policy!r}")
        # mandatory legality gate (REPRO_VERIFY=off to bypass); lazy import —
        # analysis sits above core in the layering
        from ..analysis.verify import check_plan
        check_plan(ir, plan, db=self.db, where="PipelineGenerator.generate")
        fns = make_stage_fns(ir, self.db, plan)
        cap = dict(ir.captured)
        token_inputs = [g for g in ir.graph_inputs if g not in cap]
        return BuiltPipeline(ir=ir, plan=plan, stage_fns=fns,
                             graph_inputs=token_inputs,
                             graph_outputs=list(ir.graph_outputs),
                             max_in_flight=max_in_flight, captured=cap)
