"""AdamW over parameter trees — the port of the JAX package's
``optim/adamw.py``.

The same arithmetic and defaults: moments in f32 whatever the parameter's
type, global-norm clipping (the clipped gradient cast back to its type),
bias correction, decoupled weight decay, the update done in f32 and cast
back to the parameter's type.  PyTorch's idiom replaces the functional
update: :func:`adamw_update` writes the new parameters and moments into the
given tensors under ``torch.no_grad()`` (and clips the gradients in place),
so a step holds one copy of the state.  The state's ``step`` is a 0-d int32
tensor on the parameters' device, and nothing here waits for the card.

Parameters that are DTensors (tensor-parallel training across ranks) get
moments that are DTensors laid out as their parameter (``opt_shardings``),
each rank allocating only its shard; the update runs on each rank's local
tensors, in place, with the same arithmetic, and :func:`global_norm` sums
the squares of the sharded leaves' shards over the ranks once (over the
model axis, and over ``data`` for a leaf whose storage-only dim is split
there), so the norm and the clip scale are the same number on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..core.spmd_pipeline import (group_transport, is_dtensor, like_dtensor,
                                   local_tensor, reduce_over_ranks,
                                   sharded_dims)
from ..core.tree import leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


def adamw_init(params: Params) -> AdamWState:
    """f32 zero moments shaped as the parameters (a DTensor parameter's
    laid out as it, only the local shard allocated) and ``step`` 0."""
    def zeros(p):
        local = local_tensor(p)
        return like_dtensor(torch.zeros(local.shape, dtype=torch.float32,
                                        device=local.device), p)

    device = local_tensor(leaves(params)[0]).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  Over DTensors:
    the squares of each sharded leaf's local shard summed over the ranks
    that split it (one small all-reduce), each leaf every rank holds whole
    counted once."""
    xs = leaves(tree)
    if not any(is_dtensor(x) for x in xs):
        sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square()
              for x in xs]
        return torch.sqrt(torch.stack(sq).sum())
    by_dims: dict = {}
    for x in xs:
        sq = torch.linalg.vector_norm(local_tensor(x),
                                      dtype=torch.float32).square()
        by_dims.setdefault(sharded_dims(x), []).append((x, sq))
    total = []
    for dims, part in by_dims.items():
        s = torch.stack([sq for _, sq in part]).sum()
        x = part[0][0]
        for m in dims:                        # the ranks holding the parts
            group = x.device_mesh.get_group(m)
            s = reduce_over_ranks(s, group, group_transport(group, s.device))
        total.append(s)
    return torch.sqrt(torch.stack(total).sum())


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    """Scale ``grads`` (in place) by min(1, max_norm / norm); returns
    (grads, norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves(grads):
        local_tensor(g).mul_(scale)   # f32 product, cast to g's type
    return grads, norm


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """Linear warmup to ``base_lr``, then a cosine decay to 0 at ``total``."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState, params: Params, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: float | None = 1.0
                 ) -> tuple[Params, AdamWState, dict]:
    """One AdamW step, in place: returns (params, the new state, {"grad_norm",
    "lr"}); ``params`` and the state's moments are the tensors given,
    updated."""
    if max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr_t = (lr(step) if callable(lr)
            else torch.as_tensor(lr, dtype=torch.float32, device=step.device))
    c1 = 1.0 - torch.pow(torch.full((), b1, device=step.device), stepf)
    c2 = 1.0 - torch.pow(torch.full((), b2, device=step.device), stepf)
    for p, g, m, v in zip(*(map(local_tensor, leaves(t)) for t in
                            (params, grads, state.m, state.v))):
        g32 = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        del g32
        p32 = p.to(torch.float32)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p32
        p.copy_(p32 - lr_t * delta)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr_t}
