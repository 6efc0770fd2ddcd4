"""Checkpointing — atomic, manifest-verified, async-capable, keep-last-k.

The port of the JAX package's ``checkpoint/store.py``, with its layout and
guarantees:  ``<root>/step_<n>/`` holds ``arrays.npz`` + ``manifest.json``,
staged in a ``.tmp`` directory and published by one rename, so a crash
mid-save never corrupts the latest step.  Each leaf's shape, dtype and a
sha1 digest of its bytes are in the manifest and checked on restore before
anything is put on a device.  Trees flatten in ``jax.tree.flatten``'s
order (:mod:`repro_torch.core.tree`), and bf16 leaves go to disk as byte
views with the dtype string ``"bfloat16"``, as the JAX store writes them:
a checkpoint written by either package restores into the other's tree.

A sharded train state (DTensor leaves, the ranks of
:func:`~repro_torch.launch.mesh.run_on_local_mesh`) saves as the JAX store
saves a sharded ``jax.Array``: every leaf whole.  :meth:`save` gathers
each DTensor leaf over the mesh axes that split it, in the caller's
thread, through the port's own collectives
(:func:`~repro_torch.core.spmd_pipeline.gather_over_ranks`: gloo has no
CUDA all-gather); global rank 0 alone writes and collects old steps, and
every rank returns after a barrier that follows the rename, so
:meth:`latest_step` then agrees on every rank.  :meth:`restore` with
``shardings`` (a tree of the port's ``NamedSharding``, as
``param_shardings``/``opt_shardings`` give them) cuts each whole leaf to
the rank's shard and wraps it as a DTensor, as ``distribute_params``
does: every rank reads the file, nothing is communicated.  On a mesh
with a ``stage`` axis (replicated: no rule splits over it) the gathers
run over the axes that split a leaf alone, global rank 0 still writes
once, and ``restore(shardings=)`` gives every stage index the same shard.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core.spmd_pipeline import (gather_over_ranks, group_transport,
                                   is_dtensor, local_tensor)
from ..core.tree import flatten, tree_map, unflatten

Params = Any


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._async_thread: threading.Thread | None = None
        self._async_barrier = False

    # -- paths ----------------------------------------------------------------- #
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save -------------------------------------------------------------------- #
    def save(self, step: int, tree: Params, extra: dict | None = None) -> str:
        """Write ``tree`` at ``step``; a tree with DTensor leaves is a
        collective (the module docstring): call it on every rank."""
        sharded = _sharded(tree)
        tree = tree_map(_gathered, tree) if sharded else tree
        final = self._write(step, tree, extra, _writes(sharded))
        if sharded:
            dist.barrier()
        return final

    def _write(self, step: int, tree: Params, extra: dict | None,
               writes: bool) -> str:
        final = self._dir(step)
        if not writes:
            return final
        leaves, treedef = flatten(tree)
        raw = [_to_numpy(x) for x in leaves]        # (bytes-ready array, dtype)
        arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(raw)}
        manifest = {
            "step": step,
            "treedef": str(treedef),
            "n_leaves": len(leaves),
            "leaves": [{"shape": list(_shape(x)), "dtype": dt,
                        "sum": _digest(a)} for x, (a, dt) in zip(leaves, raw)],
            "extra": extra or {},
        }
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    def save_async(self, step: int, tree: Params,
                   extra: dict | None = None) -> None:
        """Stage host copies now, write in the background (training
        continues, and may update the device tensors in place).  A tree
        with DTensor leaves is gathered here, in the caller's thread (no
        collective runs in the background), and :meth:`wait`, on every
        rank, ends with the barrier."""
        sharded = _sharded(tree)
        host_tree = tree_map(lambda x: _host_copy(_gathered(x)), tree)
        self.wait()
        self._async_barrier = sharded
        self._async_thread = threading.Thread(
            target=self._write, args=(step, host_tree, extra,
                                      _writes(sharded)), daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_barrier:
            self._async_barrier = False
            dist.barrier()

    # -- restore ------------------------------------------------------------------ #
    def restore(self, step: int | None, like: Params,
                shardings: Params | None = None) -> tuple[Params, dict]:
        """The tree saved at ``step`` (the latest when None) in ``like``'s
        structure, each leaf of ``like``'s dtype on ``like``'s device (a
        DTensor's: its local tensor's).  ``shardings`` (a tree of the
        port's ``NamedSharding`` of ``like``'s structure, as
        ``param_shardings``/``opt_shardings`` give them): each leaf this
        rank's shard of it, a DTensor laid out by its spec (a 0-d leaf, the
        optimizer's ``step``, stays a plain tensor); no communication.
        Without ``shardings`` every leaf comes back whole, a plain tensor,
        as JAX's ``jax.device_put(a)`` gives it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        leaves_like, treedef = flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, expected "
                f"{len(leaves_like)} — incompatible tree")
        shard_leaves = (flatten(shardings)[0] if shardings is not None
                        else [None] * len(leaves_like))
        if len(shard_leaves) != len(leaves_like):
            raise ValueError(f"{len(shard_leaves)} shardings for "
                             f"{len(leaves_like)} leaves")
        out = []
        for i, (ref, meta) in enumerate(zip(leaves_like, manifest["leaves"])):
            a = data[f"leaf_{i}"]
            if _digest(a) != meta["sum"]:
                raise ValueError(f"leaf {i}: checksum mismatch (corrupt file)")
            t = _from_numpy(a, meta["dtype"], meta["shape"])
            if list(t.shape) != list(meta["shape"]):
                raise ValueError(f"leaf {i}: manifest/array mismatch")
            if tuple(t.shape) != tuple(_shape(ref)):
                raise ValueError(
                    f"leaf {i}: shape {tuple(t.shape)} != expected "
                    f"{tuple(_shape(ref))}")
            out.append(_like(t, ref) if shard_leaves[i] is None
                       else _placed(t, ref, shard_leaves[i]))
        return unflatten(treedef, out), manifest["extra"]

    # -- retention ------------------------------------------------------------------ #
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _sharded(tree: Params) -> bool:
    """Whether ``tree`` holds a DTensor leaf (a sharded state)."""
    return any(is_dtensor(x) for x in flatten(tree)[0])


def _writes(sharded: bool) -> bool:
    """Whether this process writes: global rank 0 of a sharded state's
    ranks; every process for a tree held whole."""
    return not sharded or dist.get_rank() == 0


def _gathered(x):
    """DTensor ``x`` whole: its local tensor gathered over every mesh dim
    of more than one rank that splits it, the innermost first (a dim split
    over ``pod`` and ``data`` comes back in their order); exact.  A leaf
    replicated everywhere is its local tensor; anything else as it is."""
    if not is_dtensor(x):
        return x
    dm, t = x.device_mesh, x.to_local().detach()
    for m in reversed(range(dm.ndim)):
        pl = x.placements[m]
        if pl.is_shard() and dm.size(m) > 1:
            group = dm.get_group(m)
            t = gather_over_ranks(t.contiguous(), pl.dim, group,
                                  group_transport(group, t.device))
    return t


def _placed(t: torch.Tensor, ref, sharding):
    """Whole leaf ``t`` as this rank's shard under ``sharding`` (a
    ``NamedSharding`` whose mesh has a realised ``device_mesh``): the slice
    at its bounds, on ``ref``'s device in ``ref``'s dtype, as a DTensor
    (``distribute_params``'s cut); a 0-d leaf stays a plain tensor."""
    if t.dim() == 0:
        return _like(t, ref)
    from torch.distributed.tensor import DTensor

    from ..core.spmd_pipeline import placements, shard_bounds

    dm = sharding.mesh.device_mesh
    pls = placements(dm, sharding.spec)
    local = _like(t[shard_bounds(dm, pls, t.shape)].clone(
        memory_format=torch.contiguous_format), ref)
    return DTensor.from_local(local, dm, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(an array npz can store, the dtype string of the manifest): bf16 as
    its bytes (uint8, the last dimension doubled), as the JAX store does."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            if t.dim() == 0:
                return t.reshape(1).view(torch.uint8).numpy(), "bfloat16"
            return t.view(torch.uint8).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, shape: list) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a)).view(
            torch.bfloat16).reshape(shape)
    if str(a.dtype) != dtype:
        raise ValueError(f"array of {a.dtype} where the manifest says {dtype}")
    return torch.from_numpy(np.array(a))


def _like(t: torch.Tensor, ref) -> Any:
    """``t`` in the type and on the device of the leaf ``ref`` (a DTensor's
    local tensor's device)."""
    if isinstance(ref, torch.Tensor):
        return t.to(device=local_tensor(ref).device, dtype=ref.dtype)
    return np.asarray(t.numpy()).astype(np.asarray(ref).dtype)
