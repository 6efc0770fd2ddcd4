"""Structured placement — backend kind + device + replica, end to end.

Courier-FPGA's core move is putting every pipeline stage on the execution
resource it fits best: predefined hardware modules on the FPGA fabric,
software filters on CPU cores.  Each IR node carries a :class:`Placement`
(backend kind + device ordinal / mesh coordinate + replica index), and the
:class:`DeviceInventory` lists the devices the planner maps stage replicas
onto.

THIS MODULE IS THE ONLY PLACE the literal kind strings may appear — the
back-compat parser (:meth:`Placement.parse`) accepts the legacy strings and
everything else goes through the :data:`HW`/:data:`SW` constants and the
:func:`is_hw`/:func:`is_sw`/:func:`placement_kind` helpers.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Iterator, Sequence

# --------------------------------------------------------------------------- #
# Backend kinds — the ONLY allowed spelling of the legacy strings
# --------------------------------------------------------------------------- #
HW = "hw"                    # accelerated module (CUDA kernel / FPGA module)
SW = "sw"                    # software fallback (plain PyTorch function)
UNASSIGNED = "unassigned"    # backend not yet chosen (pre-database lookup)

_KINDS = (HW, SW, UNASSIGNED)

# Reserved-core headroom knob for the budget governor (cores the widening
# pass must leave free for the OS and the host threads driving the card).
RESERVED_CORES_ENV = "REPRO_RESERVED_CORES"
DEFAULT_RESERVED_CORES = 1


def resolve_device(device: Any = None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the card: ``cuda`` when PyTorch sees one, and an error
    otherwise — an entry point never carries on on the CPU unless the caller
    asks for it with ``device="cpu"``.
    """
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


# --------------------------------------------------------------------------- #
# Placement
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Placement:
    """Where one IR node (or one stage replica) executes.

    ``kind`` is :data:`HW`, :data:`SW` or :data:`UNASSIGNED`; ``device`` an
    ordinal into the active :class:`DeviceInventory` (``None`` = unpinned);
    ``mesh_coord`` an optional mesh coordinate; ``replica`` which of the N
    parallel workers of a widened stage this placement names.
    """

    kind: str = UNASSIGNED
    device: int | None = None
    mesh_coord: tuple[int, ...] | None = None
    replica: int = 0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown placement kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.mesh_coord is not None:
            object.__setattr__(self, "mesh_coord",
                               tuple(int(c) for c in self.mesh_coord))

    # -- predicates --------------------------------------------------------- #
    @property
    def is_hw(self) -> bool:
        return self.kind == HW

    @property
    def is_sw(self) -> bool:
        return self.kind == SW

    @property
    def is_assigned(self) -> bool:
        return self.kind != UNASSIGNED

    # -- constructors ------------------------------------------------------- #
    @classmethod
    def hw(cls, device: int | None = None, replica: int = 0,
           mesh_coord: tuple[int, ...] | None = None) -> "Placement":
        return cls(kind=HW, device=device, replica=replica,
                   mesh_coord=mesh_coord)

    @classmethod
    def sw(cls, device: int | None = None, replica: int = 0,
           mesh_coord: tuple[int, ...] | None = None) -> "Placement":
        return cls(kind=SW, device=device, replica=replica,
                   mesh_coord=mesh_coord)

    @classmethod
    def unassigned(cls) -> "Placement":
        return cls()

    @classmethod
    def parse(cls, value: Any) -> "Placement":
        """THE back-compat parser: legacy strings / dicts → Placement."""
        if isinstance(value, cls):
            return value
        if value is None:
            return cls()
        if isinstance(value, str):
            return cls(kind=value)          # __post_init__ validates
        if isinstance(value, dict):
            d = dict(value)
            if d.get("mesh_coord") is not None:
                d["mesh_coord"] = tuple(d["mesh_coord"])
            return cls(**d)
        raise TypeError(f"cannot parse a Placement from {type(value).__name__}")

    # -- derivation --------------------------------------------------------- #
    def with_kind(self, kind: str) -> "Placement":
        """Same device/replica pinning, new backend kind."""
        return replace(self, kind=kind)

    def on(self, device: int | None, replica: int = 0,
           mesh_coord: tuple[int, ...] | None = None) -> "Placement":
        """Same kind, pinned to ``device`` as replica ``replica``."""
        return replace(self, device=device, replica=replica,
                       mesh_coord=mesh_coord)

    @property
    def key(self) -> tuple:
        """Hashable identity used in StageFn cache keys."""
        return (self.kind, self.device, self.replica)

    # -- rendering ---------------------------------------------------------- #
    def short(self) -> str:
        """Compact label: ``hw``, ``hw@2``, ``hw@2.1`` (device 2, replica 1)."""
        s = self.kind
        if self.device is not None:
            s += f"@{self.device}"
            if self.replica:
                s += f".{self.replica}"
        return s

    def __str__(self) -> str:
        return self.short()

    def __repr__(self) -> str:
        return f"Placement({self.short()!r})"


# -- helpers that tolerate legacy values ------------------------------------ #
def placement_kind(value: Any) -> str:
    """Backend kind of a placement-like value (string or Placement)."""
    return Placement.parse(value).kind


def is_hw(value: Any) -> bool:
    """True when a placement-like value names the accelerated backend."""
    return value is not None and Placement.parse(value).is_hw


def is_sw(value: Any) -> bool:
    return value is not None and Placement.parse(value).is_sw


# --------------------------------------------------------------------------- #
# Device inventory — what the planner places replicas onto
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class InventoryDiff:
    """Structured result of :meth:`DeviceInventory.refresh`.

    ``old``/``new`` are the inventories before/after the probe; ``lost``
    and ``gained`` name ordinals in the respective inventory's numbering;
    ``survivors`` maps each surviving OLD ordinal to its NEW ordinal (the
    re-densified numbering after a loss), which is how profiler stats
    keyed by old ordinals follow their device across a re-plan.
    """

    old: "DeviceInventory"
    new: "DeviceInventory"
    lost: tuple[int, ...] = ()         # old ordinals no longer present
    gained: tuple[int, ...] = ()       # new ordinals with no old identity
    survivors: dict = field(default_factory=dict)   # old ordinal -> new

    @property
    def changed(self) -> bool:
        return bool(self.lost or self.gained)

    def describe(self) -> str:
        return (f"InventoryDiff({len(self.old)} -> {len(self.new)} devices; "
                f"lost {list(self.lost)}, gained {list(self.gained)})")


@dataclass(frozen=True)
class DeviceSpec:
    """One placeable device: ordinal + platform + optional topology."""

    ordinal: int                       # index into the inventory
    platform: str = "cpu"              # "gpu" | "cpu"
    device_id: int | None = None       # backend device index (cuda:<id>)
    coord: tuple[int, ...] | None = None   # mesh coordinate when known
    speed: float = 1.0                 # relative throughput vs class baseline

    def __post_init__(self) -> None:
        if self.coord is not None:
            object.__setattr__(self, "coord",
                               tuple(int(c) for c in self.coord))
        if self.speed <= 0.0:
            raise ValueError(f"device speed must be > 0 (got {self.speed})")


class DeviceInventory:
    """The placeable devices the planner maps stage replicas onto.

    Built from ``torch.cuda`` (:meth:`detect`), from a mesh, or synthetically
    (:meth:`host`, for planner unit tests that need an N-device inventory
    without N cards).  :meth:`refresh` re-probes the device set and diffs it
    by identity, :meth:`drop` and :meth:`reweighted` derive the survivors'
    inventory the elastic planner re-plans onto; :meth:`from_mesh` lists
    a mesh's positions.
    """

    def __init__(self, specs: Sequence[DeviceSpec]):
        if not specs:
            raise ValueError("a DeviceInventory needs at least one device")
        self.specs: tuple[DeviceSpec, ...] = tuple(specs)
        for i, s in enumerate(self.specs):
            if s.ordinal != i:
                raise ValueError(f"spec #{i} carries ordinal {s.ordinal}; "
                                 "ordinals must be dense and ordered")

    # -- constructors ------------------------------------------------------- #
    @classmethod
    def detect(cls, limit: int | None = None,
               device: Any = None) -> "DeviceInventory":
        """Inventory over the visible CUDA devices (the first ``limit``).

        Without a card it raises, like every entry point of the port;
        ``device="cpu"`` asks for a one-device host inventory instead.
        """
        import torch

        dev = resolve_device(device)
        if dev.type == "cpu":
            return cls([DeviceSpec(ordinal=0, platform="cpu", device_id=0)])
        n = torch.cuda.device_count()
        if limit is not None:
            if limit < 1:
                raise ValueError(f"limit must be >= 1 (got {limit})")
            n = min(n, limit)
        return cls([DeviceSpec(ordinal=i, platform="gpu", device_id=i)
                    for i in range(n)])

    @classmethod
    def from_mesh(cls, mesh: Any) -> "DeviceInventory":
        """Inventory over a mesh's positions: a realised ``DeviceMesh`` (or
        a layout, whose rank is its flat index), coords the mesh
        coordinates in ``np.ndindex`` order, the ordinal the flat index,
        the ``device_id`` the rank."""
        import numpy as np

        if hasattr(mesh, "mesh_dim_names"):           # a DeviceMesh
            ranks = mesh.mesh.cpu().numpy()
            platform = "gpu" if mesh.device_type == "cuda" else "cpu"
        else:
            ranks = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
            platform = "cpu"
        return cls([DeviceSpec(ordinal=i, platform=platform,
                               device_id=int(ranks[idx]),
                               coord=tuple(int(c) for c in idx))
                    for i, idx in enumerate(np.ndindex(ranks.shape))])

    @classmethod
    def host(cls, n: int, platform: str = "cpu") -> "DeviceInventory":
        """Synthetic n-device inventory (planner tests / dry planning)."""
        return cls([DeviceSpec(ordinal=i, platform=platform, device_id=i)
                    for i in range(n)])

    # -- queries ------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self) -> Iterator[DeviceSpec]:
        return iter(self.specs)

    def _check(self, ordinal: int) -> int:
        # explicit range check: negative indexing would silently alias
        # ordinal -1 to the last device
        if not 0 <= ordinal < len(self.specs):
            raise IndexError(f"device ordinal {ordinal} out of range for a "
                             f"{len(self.specs)}-device inventory")
        return ordinal

    def spec(self, ordinal: int) -> DeviceSpec:
        return self.specs[self._check(ordinal)]

    def torch_device(self, ordinal: int):
        """The ``torch.device`` a replica pinned to ``ordinal`` runs on."""
        import torch

        spec = self.spec(ordinal)
        if spec.platform == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", spec.device_id or 0)

    def device_class(self, ordinal: int):
        """Roofline constants for the device's platform class."""
        from .costmodel import device_class
        return device_class(self.spec(ordinal).platform)

    @property
    def homogeneous(self) -> bool:
        return len({(s.platform, s.speed) for s in self.specs}) <= 1

    def worker_budget(self, n_stages: int = 1,
                      reserved_cores: int | None = None) -> int:
        """Budget governor over this inventory: never below one worker per
        stage or one worker per device."""
        return max(default_worker_budget(n_stages, reserved_cores),
                   len(self.specs))

    def describe(self) -> str:
        rows = [f"DeviceInventory({len(self.specs)} devices)"]
        for s in self.specs:
            c = f" coord={s.coord}" if s.coord else ""
            rows.append(f"  #{s.ordinal} {s.platform}"
                        f"(id={s.device_id}){c} x{s.speed:g}")
        return "\n".join(rows)

    # -- elastic inventory --------------------------------------------------- #
    def _identity(self, ordinal: int) -> tuple:
        # device identity across probes: the backend index when one exists,
        # the ordinal itself otherwise (position IS identity there)
        s = self.specs[ordinal]
        return (s.platform, s.device_id if s.device_id is not None
                else ("ordinal", ordinal))

    def refresh(self, probe: Any = None) -> InventoryDiff:
        """Re-detect the device set and diff it against this inventory.

        ``probe`` is a zero-arg callable returning the NEW
        :class:`DeviceInventory` (default: :meth:`detect` over
        ``torch.cuda`` — the real re-probe, which needs a card; tests pass
        ``FaultInjector.surviving``).  Devices are matched by identity
        ``(platform, device_id)``, so a loss that re-densifies the ordinals
        still maps every survivor old→new in the returned
        :class:`InventoryDiff`.
        """
        new = probe() if probe is not None else DeviceInventory.detect()
        old_ids = {self._identity(i): i for i in range(len(self.specs))}
        new_ids = {new._identity(j): j for j in range(len(new.specs))}
        survivors = {old_ids[k]: new_ids[k] for k in old_ids if k in new_ids}
        lost = tuple(sorted(i for k, i in old_ids.items() if k not in new_ids))
        gained = tuple(sorted(j for k, j in new_ids.items()
                              if k not in old_ids))
        return InventoryDiff(old=self, new=new, lost=lost, gained=gained,
                             survivors=survivors)

    def drop(self, ordinals: Any) -> "DeviceInventory":
        """Survivors-only inventory: this one minus ``ordinals``,
        re-densified (survivor k becomes ordinal ``rank(k)``) with
        platform/id/coord/speed preserved."""
        gone = {self._check(int(o)) for o in ordinals}
        keep = [i for i in range(len(self.specs)) if i not in gone]
        if not keep:
            raise ValueError("cannot drop every device in the inventory")
        return DeviceInventory([replace(self.specs[i], ordinal=j)
                                for j, i in enumerate(keep)])

    def reweighted(self, factors: dict) -> "DeviceInventory":
        """Copy with per-ordinal speed multipliers applied (clamped
        positive) — how the replanner de-weights an unhealthy device so
        ``assign_replicas`` widens onto its healthy peers instead."""
        return DeviceInventory([
            replace(s, speed=max(s.speed * float(factors.get(s.ordinal, 1.0)),
                                 1e-6))
            for s in self.specs])


# --------------------------------------------------------------------------- #
# Budget governor — widen only when spare cores exist
# --------------------------------------------------------------------------- #
def default_worker_budget(n_stages: int = 1,
                          reserved_cores: int | None = None) -> int:
    """``os.cpu_count()`` minus a reserved-core headroom knob
    (``REPRO_RESERVED_CORES``, default 1), floored at one worker per stage."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1 (got {n_stages})")
    if reserved_cores is None:
        reserved_cores = int(os.environ.get(RESERVED_CORES_ENV,
                                            DEFAULT_RESERVED_CORES))
    if reserved_cores < 0:
        raise ValueError(f"reserved_cores must be >= 0 (got {reserved_cores})")
    cores = os.cpu_count() or 1
    return max(n_stages, cores - reserved_cores)


AUTO_BUDGET = "auto"      # sentinel: derive the budget from the governor


def resolve_worker_budget(worker_budget: Any, n_stages: int,
                          inventory: "DeviceInventory | None" = None,
                          ) -> int | None:
    """Normalize a worker-budget argument: an int is the explicit override,
    :data:`AUTO_BUDGET` the governor, ``None`` the governor when an
    inventory is given and no widening otherwise."""
    if worker_budget is None:
        if inventory is None:
            return None
        return inventory.worker_budget(n_stages)
    if worker_budget == AUTO_BUDGET:
        if inventory is not None:
            return inventory.worker_budget(n_stages)
        return default_worker_budget(n_stages)
    return int(worker_budget)
