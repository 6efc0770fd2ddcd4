"""Module database — the paper's predefined hardware-module database.

Courier-FPGA's Backend "searches corresponding predefined hardware modules
from a database by functions name" (paper Sect. III).  A hit means the
function is off-loaded to the FPGA module; a miss means the original
software function keeps running on the CPU.

H100 mapping: an *accelerated* implementation is a CUDA kernel written by
hand for Hopper (the analog of a predefined HLS module); the *software*
fallback is the plain PyTorch implementation.  Entries are keyed by function
name, exactly like the paper, with an optional applicability predicate
standing in for "the HLS library supports this data layout".
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Any, Callable

from .costmodel import NodeCost
from .placement import HW, SW


@dataclass
class ModuleEntry:
    """One database row: a library function and its implementations."""

    name: str
    software: Callable                       # plain PyTorch fallback
    accelerated: Callable | None = None      # hand-written kernel wrapper
    applicable: Callable[..., bool] | None = None   # shapes predicate
    cost_hw: Callable[..., NodeCost] | None = None  # synthesis-report analog
    cost_sw: Callable[..., NodeCost] | None = None
    tags: tuple[str, ...] = ()
    # name of the mutable per-request state this function touches, or None
    # for pure functions; stateful entries never resolve to hw
    state: str | None = None
    # True when every implementation takes leading batch dims ([..., T, d]):
    # the executor then hands a micro-batched group to the stage in one
    # call, and otherwise loops the stage over the group's rows
    batch_dims: bool = False
    # a fused module's shared-memory tile: (ir, value names) -> bytes one
    # block of its kernel holds; None reckons the stencil tile
    # (partition.stencil_tile_bytes)
    smem_tile: Callable[..., int] | None = None

    def has_hw(self, *shape_args: Any) -> bool:
        if self.accelerated is None:
            return False
        if self.applicable is not None and shape_args:
            try:
                return bool(self.applicable(*shape_args))
            except TypeError:
                return True
        return True


def _arity(fn: Callable) -> int:
    """Required positional inputs of a part's software impl."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return 1
    n = 0
    for p in sig.parameters.values():
        if (p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty):
            n += 1
    return max(n, 1)


class ModuleDatabase:
    """Name → ModuleEntry registry."""

    def __init__(self, name: str = "default"):
        self.name = name
        self.entries: dict[str, ModuleEntry] = {}

    # -- registration -------------------------------------------------------- #
    def register(self, name: str, software: Callable,
                 accelerated: Callable | None = None,
                 applicable: Callable[..., bool] | None = None,
                 cost_hw: Callable[..., NodeCost] | None = None,
                 cost_sw: Callable[..., NodeCost] | None = None,
                 tags: tuple[str, ...] = (),
                 state: str | None = None,
                 batch_dims: bool = False) -> ModuleEntry:
        if state is not None and accelerated is not None:
            raise ValueError(
                f"{name!r}: a stateful module cannot carry an accelerated "
                "impl — the slot state lives host-side")
        e = ModuleEntry(name=name, software=software, accelerated=accelerated,
                        applicable=applicable, cost_hw=cost_hw, cost_sw=cost_sw,
                        tags=tags, state=state, batch_dims=batch_dims)
        self.entries[name] = e
        return e

    def library(self, name: str, **kwargs: Any) -> Callable:
        """Decorator: register the decorated function as ``name``'s
        software implementation (``kwargs`` as :meth:`register` takes
        them)."""
        def deco(fn: Callable) -> Callable:
            self.register(name, software=fn, **kwargs)
            return fn
        return deco

    def add_accelerated(self, name: str, fn: Callable,
                        applicable: Callable[..., bool] | None = None) -> None:
        if name not in self.entries:
            raise KeyError(f"register software impl for {name!r} first")
        self.entries[name].accelerated = fn
        if applicable is not None:
            self.entries[name].applicable = applicable

    @staticmethod
    def fused_key(parts: "tuple[str, ...] | list[str]") -> str:
        """The database key a fused run of ``parts`` resolves under."""
        return "+".join(parts)

    def register_fused(self, parts: "tuple[str, ...] | list[str]",
                       accelerated: Callable,
                       applicable: Callable[..., bool] | None = None,
                       cost_hw: Callable[..., NodeCost] | None = None,
                       tags: tuple[str, ...] = (),
                       smem_tile: Callable[..., int] | None = None,
                       batch_dims: bool = False) -> ModuleEntry:
        """Register a dedicated fused hw module for a run of functions.

        The entry lives under the joined key (``"a+b+c"``) — the key
        :func:`repro_torch.core.partition.fuse_adjacent_hw` gives a fused
        node — so the backend resolves the *single-pass fused kernel*
        instead of composing the parts' kernels.  The software fallback
        composes the parts' software impls, keeping the Off-load Switcher's
        "original behavior always available" guarantee.  ``smem_tile``
        declares the fused kernel's shared-memory tile, which the fusion
        gate and the verifier's ``smem-spill`` rule reckon.
        """
        keys = list(parts)
        if len(keys) < 2:
            raise ValueError("a fused module needs >= 2 parts")
        missing = [k for k in keys if k not in self.entries]
        if missing:
            raise KeyError(f"register software impls first for {missing!r}")
        part_sw = [self.entries[k].software for k in keys]
        arities = [_arity(f) for f in part_sw]

        def composed_software(*args: Any, **kwargs: Any):
            # args follow the fused node's calling convention: part 0's
            # inputs first, then each later part's *side operands* in part
            # order (its first input is the carried previous output)
            queue = list(args)
            take = arities[0]
            out = part_sw[0](*queue[:take])
            queue = queue[take:]
            for f, ar in zip(part_sw[1:], arities[1:]):
                carry = list(out) if isinstance(out, (tuple, list)) else [out]
                extra = max(ar - len(carry), 0)
                out = f(*carry, *queue[:extra])
                queue = queue[extra:]
            return out

        e = ModuleEntry(name=self.fused_key(keys), software=composed_software,
                        accelerated=accelerated, applicable=applicable,
                        cost_hw=cost_hw, tags=tags + ("fused",),
                        batch_dims=batch_dims, smem_tile=smem_tile)
        self.entries[e.name] = e
        return e

    # -- lookup (paper: "searches ... by functions name") --------------------- #
    def lookup(self, name: str) -> ModuleEntry | None:
        return self.entries.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def resolve(self, name: str, *shape_args: Any,
                prefer_hw: bool = True) -> tuple[Callable, str]:
        """Return (callable, placement kind) for a function name: hw when an
        applicable accelerated module exists and ``prefer_hw``, else sw."""
        e = self.lookup(name)
        if e is None:
            raise KeyError(f"{name!r} not in module database {self.name!r}")
        if prefer_hw and e.has_hw(*shape_args):
            return e.accelerated, HW
        return e.software, SW

    def names(self) -> list[str]:
        return sorted(self.entries)


# A process-wide default database, like the toolchain's single module DB.
default_db = ModuleDatabase("courier-default")
