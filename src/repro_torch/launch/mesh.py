"""Meshes — the port of the JAX package's ``launch/mesh.py`` on
``torch.distributed``.

A :class:`MeshLayout` holds axis names and sizes and no devices, so the
production meshes (:func:`make_production_mesh`, 16 x 16 and 2 x 16 x 16;
:func:`make_pipeline_mesh`) are plans that the sharding rules read on one
host: ``axis_names`` and ``shape[axis]``, as on a JAX mesh.
:meth:`MeshLayout.device_mesh` realises a layout as a ``DeviceMesh`` once
a process group of its size is up.

:func:`run_on_local_mesh` is the counterpart of JAX's forced host devices:
it spawns one process per mesh position, starts their process group from a
``FileStore`` in a directory of its own (never a fixed port: several test
workers spawn meshes at once), runs ``fn(mesh, *args)`` in every rank with
that rank's :class:`RankMesh`, and returns the ranks' results in rank
order.  The group has a timeout and the join a deadline, so a hang fails
the call.  Ranks print nothing; results come back through files.

The transport follows the topology and never changes on an error:

* ``nccl`` when each rank has a card of its own;
* ``gloo+pinned`` when ranks share a card (one H100): compute stays on the
  card, and each hand-off is staged through pinned host memory, the
  paper's DDR3 hand-off;
* ``gloo`` on the CPU (``device="cpu"``, the tests).
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from ..core.placement import resolve_device

__all__ = ["MeshLayout", "RankMesh", "make_production_mesh",
           "make_pipeline_mesh", "batch_axes", "run_on_local_mesh",
           "current_mesh", "choose_transport"]


@dataclass(frozen=True)
class MeshLayout:
    """A logical mesh: axis names and sizes, row-major over the ranks."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for axes "
                             f"{self.axis_names}")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in axis order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, (int(n) for n in self.sizes)))

    @property
    def size(self) -> int:
        return int(math.prod(self.sizes))

    def coords(self, rank: int) -> tuple[int, ...]:
        """The mesh coordinates of ``rank`` (row-major, ``np.ndindex``
        order)."""
        return tuple(int(c) for c in np.unravel_index(rank, self.sizes))

    def device_mesh(self, device_type: str = "cuda"):
        """This layout as a ``DeviceMesh`` over ranks ``0..size-1``.  A
        collective: every rank of a process group of exactly ``size``
        ranks calls it."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if not dist.is_initialized():
            raise RuntimeError("no process group: realise a MeshLayout "
                               "inside run_on_local_mesh or after "
                               "init_process_group")
        if dist.get_world_size() != self.size:
            raise ValueError(f"a {self.sizes} mesh needs {self.size} ranks, "
                             f"the group has {dist.get_world_size()}")
        return DeviceMesh(device_type,
                          torch.arange(self.size).reshape(self.sizes),
                          mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips when ``multi_pod``."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_pipeline_mesh(*, n_stages: int = 4,
                       multi_pod: bool = False) -> MeshLayout:
    """Courier pipeline mode: the model axis split into (stage, model), so
    the Pipeline Generator's stage boundaries map onto the ``stage``
    axis."""
    tp = 16 // n_stages
    if n_stages * tp != 16:
        raise ValueError("n_stages must divide 16")
    if multi_pod:
        return MeshLayout((2, 16, n_stages, tp),
                          ("pod", "data", "stage", "model"))
    return MeshLayout((16, n_stages, tp), ("data", "stage", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# --------------------------------------------------------------------------- #
# One process a mesh position
# --------------------------------------------------------------------------- #
def choose_transport(world: int, device: Any = None) -> tuple[str, list]:
    """(transport, the device of each rank) for ``world`` ranks on
    ``device``'s type: ``nccl`` with a card a rank, ``gloo+pinned`` when
    ranks share cards (rank r on card r mod n), ``gloo`` on the CPU."""
    import torch

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * world
    n = torch.cuda.device_count()
    devices = [f"cuda:{r % n}" for r in range(world)]
    return ("nccl" if world <= n else "gloo+pinned"), devices


@dataclass
class RankMesh:
    """What a rank of :func:`run_on_local_mesh` sees: the layout, its rank
    and coordinates, its device, the transport, and one process group per
    axis (the ranks that differ from it only along that axis).  It reads
    like a layout (``axis_names``, ``shape``), so the sharding rules take
    it as they take a :class:`MeshLayout`."""

    layout: MeshLayout
    rank: int
    device: Any
    transport: str
    groups: dict = field(default_factory=dict)   # axis -> (group, ranks)
    _device_mesh: Any = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.layout.axis_names

    @property
    def shape(self) -> dict[str, int]:
        return self.layout.shape

    @property
    def size(self) -> int:
        return self.layout.size

    @property
    def coord(self) -> tuple[int, ...]:
        return self.layout.coords(self.rank)

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis`` (JAX's ``axis_index``)."""
        return self.coord[self.axis_names.index(axis)]

    def axis_group(self, axis: str):
        """(process group, global ranks in axis order) of this rank's line
        along ``axis``."""
        return self.groups[axis]

    @property
    def device_mesh(self):
        """The layout realised as a ``DeviceMesh`` on this rank's device
        type (a collective the first time: call it on every rank)."""
        if self._device_mesh is None:
            self._device_mesh = self.layout.device_mesh(self.device.type)
        return self._device_mesh


_CURRENT: RankMesh | None = None


def current_mesh() -> RankMesh | None:
    """The :class:`RankMesh` of this process inside
    :func:`run_on_local_mesh`, else None."""
    return _CURRENT


def _axis_groups(layout: MeshLayout) -> dict:
    """Every axis line's process group, made in the same order on every
    rank (``new_group`` is a collective); this rank's line kept."""
    import torch.distributed as dist

    ranks = np.arange(layout.size).reshape(layout.sizes)
    me = dist.get_rank()
    out = {}
    for d, axis in enumerate(layout.axis_names):
        lines = np.moveaxis(ranks, d, -1).reshape(-1, layout.sizes[d])
        for line in lines:
            line = [int(r) for r in line]
            group = dist.new_group(line)
            if me in line:
                out[axis] = (group, line)
    return out


def _rank_main(rank: int, layout: MeshLayout, transport: str, device: str,
               out_dir: str, timeout_s: float, results) -> None:
    """One rank: join the group, run the ``fn(mesh, *args)`` pickled in
    ``out_dir``, write its result there and report on ``results`` (None,
    or the traceback)."""
    global _CURRENT
    import torch
    import torch.distributed as dist

    err = None
    try:
        world = layout.size
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(out_dir, "store"), world)
        kw = {"device_id": dev} if transport == "nccl" else {}
        dist.init_process_group(
            "nccl" if transport == "nccl" else "gloo", store=store,
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
        try:
            _CURRENT = RankMesh(layout, rank, dev, transport,
                                _axis_groups(layout))
            with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
                fn, args, kwargs = pickle.load(f)
            result = fn(_CURRENT, *args, **kwargs)
            torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        finally:
            _CURRENT = None
            dist.destroy_process_group()
    except BaseException as e:               # reported to the parent, which
        err = "".join(traceback.format_exception(e))     # fails the call
    results.put((rank, err))


def run_on_local_mesh(shape: Sequence[int], axes: Sequence[str],
                      fn: Callable, *args, device: Any = None,
                      timeout: float = 300.0, **kwargs) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` in one spawned process per
    position of a ``shape`` mesh with axis names ``axes``; return the
    results in rank order (each rank's own, loaded from the file it wrote).

    ``fn`` and its arguments are pickled (``fn`` by import path).  The
    default device is the card; ``device="cpu"`` runs the ranks on the
    host over gloo.  Raises ``RuntimeError`` with the traceback of the
    first rank that failed, and ``TimeoutError`` when the ranks do not all
    finish within ``timeout`` seconds (every rank is killed either way).
    """
    import multiprocessing as mp

    import torch

    layout = MeshLayout(tuple(int(n) for n in shape), tuple(axes))
    world = layout.size
    transport, devices = choose_transport(world, device)
    print(f"[mesh] {world} ranks {layout.shape} over {transport}"
          + (": hand-offs staged through pinned host memory, ranks sharing "
             f"{sorted(set(devices))}" if transport == "gloo+pinned" else
             f" on {sorted(set(devices))}"), flush=True)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        # the call goes through a file: a spawn's pipe that outgrows its
        # buffer holds start() until the child has imported its modules
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args, kwargs), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, layout, transport, devices[r], tmp,
                                   float(timeout), results))
                 for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            reported: set[int] = set()
            while len(reported) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"mesh {layout.shape}: ranks "
                        f"{sorted(set(range(world)) - reported)} still "
                        f"running after {timeout} s")
                try:
                    rank, err = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in reported
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of mesh {layout.shape} exited "
                            f"with code {procs[dead[0]].exitcode} and no "
                            f"report") from None
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of mesh {layout.shape} "
                                       f"failed:\n{err}")
                reported.add(rank)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    raise TimeoutError(f"mesh {layout.shape}: a rank did not "
                                       f"exit by its deadline")
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
            results.close()
