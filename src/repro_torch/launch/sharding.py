"""Sharding rules — the port of the JAX package's ``launch/sharding.py``:
parameter, optimizer, cache, batch and activation layouts on a mesh.

Scheme (the JAX package's, rule for rule):
  * tensor-parallel dim → "model" (attention heads / FFN hidden / experts)
  * a second, storage-only dim → "data" (FSDP-style)
  * optimizer moments follow their parameter
  * KV caches: batch → ("pod", "data"); kv-heads → "model" when divisible,
    else head_dim → "model"
  * activations (train): the sequence-parallel spec (batch, "model", —)

Every rule is divisibility-guarded: a dim that does not divide its mesh
axis is left unsharded.  A spec is a :class:`P`, one entry a tensor dim:
None, an axis name, or a tuple of names (the dim split over all of them,
the first outermost).  ``mesh`` is anything with ``axis_names`` and
``shape[axis]``: a :class:`~repro_torch.launch.mesh.MeshLayout`, a
:class:`~repro_torch.launch.mesh.RankMesh`.  Paths are the port's
nested-dict keys joined by "/" (the JAX ``_path_str`` of the same leaf).
:func:`placements` turns a spec into DTensor placements on a realised
``DeviceMesh``; :func:`distribute_params` turns a params tree held whole
into DTensors by :func:`param_shardings_serving`, each rank keeping its
own shard (the tensor-parallel serving of
:mod:`repro_torch.models.layers`).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

from .mesh import batch_axes

__all__ = ["P", "NamedSharding", "guard_spec", "param_spec",
           "param_shardings", "drop_data", "param_shardings_serving",
           "opt_shardings", "batch_spec", "act_spec", "cache_spec",
           "cache_shardings", "placements", "local_shape", "with_spec",
           "map_with_path", "path_str", "to_dtensor",
           "distribute_params"]


class P(tuple):
    """A partition spec (JAX's ``PartitionSpec``): one entry a tensor
    dim; a one-name tuple is that name, as JAX canonicalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __getnewargs__(self) -> tuple:          # unpickled entry by entry
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: P


def path_str(path) -> str:
    """A leaf's path (a sequence of keys, or a string) as "a/b/c"."""
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples
    (``jax.tree.map_with_path``; a path is a tuple of keys)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def guard_spec(mesh, spec, shape: tuple[int, ...]) -> P:
    """Drop spec axes whose mesh size doesn't divide the dim (public
    guard)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    return _nd(mesh, dims, shape)


def _nd(mesh, spec_dims: list, shape: tuple[int, ...]) -> P:
    """Build a spec, dropping axes that don't divide."""
    out = []
    for dim, want in zip(shape, spec_dims):
        if want is None:
            out.append(None)
            continue
        axes = want if isinstance(want, tuple) else (want,)
        good: list[str] = []
        rem = dim
        for a in axes:
            if a in mesh.axis_names and rem % mesh.shape[a] == 0:
                good.append(a)
                rem //= mesh.shape[a]
        out.append(tuple(good) if len(good) > 1 else (good[0] if good else None))
    return P(*out)


# --------------------------------------------------------------------------- #
# parameter rules (path-pattern → dim spec), in the JAX package's order
# --------------------------------------------------------------------------- #
_PARAM_RULES: list[tuple[str, list | None]] = [
    # embedding: vocab → model (TP) + d → data (FSDP)
    (r"embed/table$",        ["model", "data"]),
    # attention
    (r"attn/wq$",            ["data", "model", None]),
    (r"attn/wk$",            ["data", "model", None]),
    (r"attn/wv$",            ["data", "model", None]),
    (r"attn/wo$",            ["model", "data"]),
    # dense mlp
    (r"mlp/wi$",             ["data", None, "model"]),
    (r"mlp/wo$",             ["model", "data"]),
    # moe (experts → model = EP; within-expert ff → data for storage)
    (r"moe/router$",         [None, None]),
    (r"moe/wi$",             ["model", "data", None, None]),
    (r"moe/wo$",             ["model", "data", None]),
    # ssm (hymba)
    (r"ssm/in_proj$",        ["data", None, "model"]),
    (r"ssm/out_proj$",       ["model", "data"]),
    (r"ssm/(conv|w_dt|w_bc|A_log|dt_bias|D)$", None),   # small → replicate
    # rwkv
    (r"rwkv/(wr|wk|wv|wg|cr)$", ["data", "model"]),
    (r"rwkv/wo$",            ["model", "data"]),
    (r"rwkv/ck$",            ["data", "model"]),
    (r"rwkv/cv$",            ["model", "data"]),
    (r"rwkv/.*",             None),
    # norms & everything small
    (r".*",                  None),
]


def param_spec(mesh, path, leaf) -> P:
    """Spec for one parameter leaf (leading stacked-layer dims — the
    ``[L, ...]`` stacks, the vlm ``[G, per, ...]`` ones — unsharded)."""
    s = path_str(path)
    shape = tuple(leaf.shape)
    for pat, dims in _PARAM_RULES:
        if re.search(pat, s):
            if dims is None:
                return P()
            n_stack = len(shape) - len(dims)
            if n_stack < 0:
                return P()
            return _nd(mesh, [None] * n_stack + dims, shape)
    return P()


def param_shardings(mesh, params: Any) -> Any:
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(mesh, path, leaf)),
        params)


def drop_data(spec) -> P:
    """Remove the FSDP ("data") axis from a spec (serving layout)."""
    out = []
    for s in spec:
        if s is None:
            out.append(None)
        elif isinstance(s, tuple):
            kept = tuple(a for a in s if a != "data")
            out.append(kept if kept else None)
        else:
            out.append(None if s == "data" else s)
    return P(*out)


def param_shardings_serving(mesh, params: Any) -> Any:
    """TP-only weights (no FSDP): serving re-gathers nothing a step."""
    return map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, drop_data(param_spec(mesh, path, leaf))),
        params)


def opt_shardings(mesh, opt_state: Any, params: Any) -> Any:
    """Moments mirror their parameter's sharding; step is replicated."""
    pshard = param_shardings(mesh, params)
    return type(opt_state)(step=NamedSharding(mesh, P()), m=pshard, v=pshard)


# --------------------------------------------------------------------------- #
# batch / cache / activation specs
# --------------------------------------------------------------------------- #
def _batch_entry(mesh):
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else (ba[0] if ba else None)


def batch_spec(mesh) -> P:
    return P(_batch_entry(mesh), None)


def act_spec(mesh) -> P:
    """Sequence-parallel activation spec [B, S, d]."""
    return P(_batch_entry(mesh), "model", None)


def cache_spec(mesh, cfg, path, leaf) -> P:
    """KV cache / recurrent state spec (the leaf has a leading layer
    dim)."""
    del cfg
    s = path_str(path)
    shape = tuple(leaf.shape)
    b = _batch_entry(mesh)
    bdim = shape[1] if len(shape) > 1 else 1

    def bspec():
        # batch must divide; else replicate (long_500k batch=1)
        if b is None:
            return None
        n = math.prod(mesh.shape[a] for a in (b if isinstance(b, tuple)
                                              else (b,)))
        return b if bdim % n == 0 else None

    if re.search(r"(^|/)(k|v)$", s) and len(shape) == 5:
        # [L, B, M, KV, hd]
        L, B, M, KV, hd = shape
        kv_ax = "model" if _div(KV, mesh, "model") else None
        hd_ax = "model" if kv_ax is None and _div(hd, mesh, "model") else None
        return P(None, bspec(), None, kv_ax, hd_ax)
    if re.search(r"ssm/h$", s) or re.search(r"/S$", s):
        dims = [None, bspec()] + [None] * (len(shape) - 2)
        # shard the first trailing dim that divides over model
        for i in range(2, len(shape)):
            if _div(shape[i], mesh, "model"):
                dims[i] = "model"
                break
        return P(*dims)
    if len(shape) >= 2:
        dims = [None, bspec()] + [None] * (len(shape) - 2)
        for i in range(len(shape) - 1, 1, -1):
            if _div(shape[i], mesh, "model"):
                dims[i] = "model"
                break
        return P(*dims)
    return P()


def cache_shardings(mesh, cfg, cache: Any) -> Any:
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_spec(mesh, cfg, path,
                                                          leaf)),
        cache)


# --------------------------------------------------------------------------- #
# specs realised
# --------------------------------------------------------------------------- #
def placements(device_mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh`` (whose dim names
    are the spec's axes): ``Shard(d)`` on every mesh dim named in tensor
    dim d's entry, ``Replicate()`` on the rest.  A dim over two axes
    (``("pod", "data")``) is ``Shard(d)`` on both, split in mesh-dim order,
    as the spec's tuple orders them."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shape(mesh, spec, shape: tuple[int, ...]) -> tuple[int, ...]:
    """A shard's shape under ``spec`` (the dims divide: guarded specs)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[d] //= mesh.shape[a]
    return tuple(out)


def with_spec(x, spec):
    """``x`` redistributed to ``spec`` when it is a DTensor; a plain tensor
    (held whole by one process) unchanged."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def to_dtensor(mesh, local, spec, shape: tuple[int, ...]):
    """A DTensor of global ``shape`` (contiguous) under ``spec`` on
    ``mesh.device_mesh`` from this rank's shard ``local``; no
    communication (every rank passes its own shard)."""
    import torch
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, dm, placements(dm, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def distribute_params(mesh, params: Any) -> Any:
    """A params tree held whole on every rank (as the JAX→port converter
    gives it, or drawn from one seed) as DTensors by
    :func:`param_shardings_serving`: each rank keeps a contiguous copy of
    its shard (:func:`local_shape` of each leaf) and nothing else of the
    leaf; no communication."""
    import torch

    from ..core.spmd_pipeline import shard_bounds
    from ..core.tree import tree_map

    dm = mesh.device_mesh

    def cut(a, sh):
        at = shard_bounds(dm, placements(dm, sh.spec), a.shape)
        local = a[at].clone(memory_format=torch.contiguous_format)
        return to_dtensor(mesh, local, sh.spec, tuple(a.shape))

    return tree_map(cut, params, param_shardings_serving(mesh, params))
