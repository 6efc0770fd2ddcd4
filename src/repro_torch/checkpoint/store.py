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

from ..core.tree import flatten, tree_map, unflatten

Params = Any


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._async_thread: threading.Thread | None = None

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
        tmp = self._dir(step) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = self._dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    def save_async(self, step: int, tree: Params,
                   extra: dict | None = None) -> None:
        """Stage host copies now, write in the background (training
        continues, and may update the device tensors in place)."""
        host_tree = tree_map(_host_copy, tree)
        self.wait()
        self._async_thread = threading.Thread(
            target=self.save, args=(step, host_tree, extra), daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # -- restore ------------------------------------------------------------------ #
    def restore(self, step: int | None, like: Params) -> tuple[Params, dict]:
        """The tree saved at ``step`` (the latest when None) in ``like``'s
        structure, each leaf of ``like``'s dtype on ``like``'s device."""
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
            out.append(_like(t, ref))
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
    """``t`` in the type and on the device of the leaf ``ref``."""
    if isinstance(ref, torch.Tensor):
        return t.to(device=ref.device, dtype=ref.dtype)
    return np.asarray(t.numpy()).astype(np.asarray(ref).dtype)
