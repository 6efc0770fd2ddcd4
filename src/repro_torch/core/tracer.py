"""Frontend — runtime trace of an unmodified program (paper Sect. II-A).

Courier-FPGA's Frontend needs no source access: it interposes on the shared
library (dlsym/RTLD_NEXT) while the binary runs, gathers runtime information
(Step 2) and recovers the *causal* function-call graph including input/output
data (Step 3) by matching each call's inputs against earlier calls' outputs.

PyTorch mapping: the "shared library" is the set of functions registered in
the ModuleDatabase, exposed through a :class:`Library` namespace.  The call
sites in user code never change; what a call *binds to* is decided by a
dynamically scoped execution context — exactly the LD_PRELOAD/dlsym trick:

* default        → software implementation (the original binary's behavior)
* ``Frontend.trace`` → software implementation + recording (Steps 1-3)
* ``deploy(plan)``   → the Off-loader's resolved implementation (Step 9)

Causality is discovered with the paper's heuristic: an input tensor whose
``id()`` matches a previously produced output is an edge; anything else is a
graph input.  A torch in-place op returns its operand itself, so its output
id equals its input id; the tracer records that as an alias (a fresh value
and an identity edge), never as one value both read and written by a node.
"""
from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .costmodel import synchronize
from .database import ModuleDatabase, ModuleEntry, default_db
from .ir import CourierIR, Node, dtype_name, flatten

__all__ = ["Library", "Frontend", "deploy", "current_mode",
           "TraceBindingError"]


# --------------------------------------------------------------------------- #
# Dynamically scoped dispatch (the dlsym/RTLD_NEXT analog)
# --------------------------------------------------------------------------- #
class _DispatchState(threading.local):
    def __init__(self):
        self.stack: list[Any] = []


_state = _DispatchState()


def _current() -> "Any | None":
    return _state.stack[-1] if _state.stack else None


def current_mode() -> str:
    """The innermost active context's mode on this thread: ``"trace"``
    inside :meth:`Frontend.trace`, ``"deploy"`` inside :class:`deploy`,
    else ``"direct"`` (for hooks that edit the IR, paper Steps 6-7)."""
    return getattr(_current(), "mode", "direct")


class Library:
    """Interposable namespace over a ModuleDatabase.

    ``lib.cvtColor(x)`` behaves like the plain software function until a
    trace/deploy context is active — user code is never edited.
    """

    def __init__(self, db: ModuleDatabase | None = None):
        object.__setattr__(self, "_db", db or default_db)

    @property
    def db(self) -> ModuleDatabase:
        return self._db

    def __getattr__(self, name: str) -> Callable:
        entry = self._db.lookup(name)
        if entry is None:
            raise AttributeError(f"{name!r} is not a registered library function")

        def call(*args: Any, **kwargs: Any):
            ctx = _current()
            if ctx is None:
                return entry.software(*args, **kwargs)
            return ctx.call(entry, *args, **kwargs)

        call.__name__ = name
        return call


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _meta(a: Any) -> tuple[tuple[int, ...], str]:
    return tuple(a.shape), dtype_name(a.dtype)


# --------------------------------------------------------------------------- #
# Trace context (Frontend Steps 1-3)
# --------------------------------------------------------------------------- #
@dataclass
class _TraceRecord:
    fn_key: str
    in_ids: list[int]
    out_ids: list[int]
    in_meta: list[tuple[tuple[int, ...], str]]
    out_meta: list[tuple[tuple[int, ...], str]]
    in_kw: list[str | None]                # keyword per input (None = positional)
    in_arrays: list[Any]                   # the operands themselves (staging)
    params: dict[str, Any]
    time_ms: float
    t_start: float
    t_end: float


def _positional_param_names(fn: Callable) -> list[str | None] | None:
    """Names of fn's positional parameters, in order, for replay rebinding.

    ``None`` entries mark POSITIONAL_ONLY params; a ``None`` return means the
    signature is unavailable and nothing can be rebound.  The list stops at
    ``*args``.
    """
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    names: list[str | None] = []
    for p in sig.parameters.values():
        if p.kind == p.POSITIONAL_OR_KEYWORD:
            names.append(p.name)
        elif p.kind == p.POSITIONAL_ONLY:
            names.append(None)
        else:
            break
    return names


class TraceBindingError(TypeError):
    """A call shape the tracer cannot replay through stage functions."""


class _TraceContext:
    mode = "trace"

    def __init__(self, profile: bool = True):
        self.records: list[_TraceRecord] = []
        self.keep_alive: list[Any] = []        # prevent id() reuse during trace
        self.profile = profile
        self.t0 = time.perf_counter()

    def call(self, entry: ModuleEntry, *args: Any, **kwargs: Any):
        # Record every array operand together with HOW it was bound:
        # positional arrays stay positional, keyword arrays keep their
        # keyword; non-array positionals fold into params by parameter name,
        # and every later positional must then be rebound by name too.
        arr_in: list[Any] = []
        in_kw: list[str | None] = []
        params: dict[str, Any] = {}
        pos_names = _positional_param_names(entry.software)

        def name_of(i: int) -> str:
            if pos_names is None or i >= len(pos_names) or pos_names[i] is None:
                raise TraceBindingError(
                    f"{entry.name!r}: positional argument {i} cannot be "
                    f"rebound by keyword for replay (no inspectable name); "
                    f"pass it by keyword or simplify the call")
            return pos_names[i]

        shifted = False
        for i, a in enumerate(args):
            if _is_array(a):
                in_kw.append(name_of(i) if shifted else None)
                arr_in.append(a)
            else:
                params[name_of(i)] = a
                shifted = True
        for k, v in kwargs.items():
            if _is_array(v):
                arr_in.append(v)
                in_kw.append(k)
            else:
                params[k] = v
        # metadata before the call: an in-place op may reshape its operand
        in_meta = [_meta(a) for a in arr_in]
        t_start = time.perf_counter() - self.t0
        t = time.perf_counter()
        out = entry.software(*args, **kwargs)
        if self.profile:
            synchronize(out)
        dt = (time.perf_counter() - t) * 1e3
        t_end = time.perf_counter() - self.t0
        outs = out if isinstance(out, (tuple, list)) else (out,)
        arr_out = [o for o in outs if _is_array(o)]
        self.keep_alive.extend(arr_in + arr_out)
        self.records.append(_TraceRecord(
            fn_key=entry.name,
            in_ids=[id(a) for a in arr_in],
            out_ids=[id(a) for a in arr_out],
            in_meta=in_meta,
            out_meta=[_meta(a) for a in arr_out],
            in_kw=in_kw, in_arrays=list(arr_in),
            params=params,
            time_ms=dt, t_start=t_start, t_end=t_end))
        return out


class Frontend:
    """Builds a CourierIR from one observed run of an unmodified callable."""

    def __init__(self, db: ModuleDatabase | None = None):
        self.db = db or default_db

    def trace(self, fn: Callable, *args: Any, profile: bool = True,
              name: str | None = None, **kwargs: Any) -> tuple[CourierIR, Any]:
        ctx = _TraceContext(profile=profile)
        _state.stack.append(ctx)
        try:
            out = fn(*args, **kwargs)
        finally:
            _state.stack.pop()
        ir = self._build_ir(ctx, args, kwargs, out,
                            name or getattr(fn, "__name__", "trace"))
        return ir, out

    # -- Step 3: causal graph reconstruction --------------------------------- #
    def _build_ir(self, ctx: _TraceContext, args: Any, kwargs: Any, out: Any,
                  name: str) -> CourierIR:
        ir = CourierIR(name)
        id2val: dict[int, str] = {}
        counter = [0]

        def fresh(meta: tuple, producer: str | None) -> str:
            vname = f"d{counter[0]}"
            counter[0] += 1
            ir.add_value(vname, meta[0], meta[1], producer=producer)
            return vname

        def val_for(aid: int, meta: tuple, producer: str | None) -> str:
            if aid in id2val:
                return id2val[aid]
            vname = fresh(meta, producer)
            id2val[aid] = vname
            return vname

        # graph inputs first (paper: data nodes of the running binary) —
        # every array leaf of the call, positional AND keyword
        for a in flatten((args, kwargs)):
            if _is_array(a):
                vn = val_for(id(a), _meta(a), None)
                if vn not in ir.graph_inputs:
                    ir.graph_inputs.append(vn)

        per_key: dict[str, int] = {}
        for r in ctx.records:
            idx = per_key.get(r.fn_key, 0)
            per_key[r.fn_key] = idx + 1
            nname = f"{r.fn_key}_{idx}"
            ins: list[str] = []
            for aid, m, arr in zip(r.in_ids, r.in_meta, r.in_arrays):
                first_seen = aid not in id2val
                vn = val_for(aid, m, None)
                if first_seen:
                    # first sighting mid-trace: a closure-captured operand,
                    # not a top-level argument — a graph input whose tensor
                    # is retained for staging
                    ir.graph_inputs.append(vn)
                    ir.captured[vn] = arr
                ins.append(vn)
            outs: list[str] = []
            for o, m in zip(r.out_ids, r.out_meta):
                if o in id2val:
                    # aliasing (an in-place op returns its operand): mint a
                    # fresh value (an identity edge) and repoint later
                    # consumers of this tensor at the alias
                    vn = fresh(m, nname)
                    id2val[o] = vn
                    outs.append(vn)
                else:
                    outs.append(val_for(o, m, nname))
            entry = self.db.lookup(r.fn_key)
            state = entry.state if entry is not None else None
            ir.add_node(Node(name=nname, fn_key=r.fn_key, inputs=ins,
                             outputs=outs, input_kw=list(r.in_kw),
                             params=r.params,
                             time_ms=r.time_ms if ctx.profile else None,
                             t_start=r.t_start, t_end=r.t_end,
                             state=state, serial_only=bool(state)))

        for a in flatten(out):
            if not _is_array(a):
                continue
            aid = id(a)
            if aid not in id2val:
                # returned tensor no library call ever saw (constant, or a
                # passthrough of something outside the traced args)
                vn = val_for(aid, _meta(a), None)
                ir.graph_inputs.append(vn)
                ir.captured[vn] = a
            ir.graph_outputs.append(id2val[aid])
        ir.validate()
        return ir


# --------------------------------------------------------------------------- #
# Deploy context (Off-loader Step 9) — see offloader.py for plan construction
# --------------------------------------------------------------------------- #
class _DeployContext:
    mode = "deploy"

    def __init__(self, resolve: Callable[[ModuleEntry], Callable]):
        self._resolve = resolve

    def call(self, entry: ModuleEntry, *args: Any, **kwargs: Any):
        return self._resolve(entry)(*args, **kwargs)


class deploy:
    """``with deploy(plan):`` — run the same user code with calls rebound.

    ``plan`` must provide ``resolve(entry) -> callable`` (see
    :class:`repro_torch.core.offloader.OffloadPlan`).
    """

    def __init__(self, plan: Any):
        self.plan = plan

    def __enter__(self):
        _state.stack.append(_DeployContext(self.plan.resolve))
        return self.plan

    def __exit__(self, *exc: Any):
        _state.stack.pop()
        return False
