"""Scan helpers — time-chunked remat for long recurrences.

The port of the JAX package's ``models/scan_utils.py``.  ``lax.scan`` is a
Python loop over the steps that stacks the ys.  :func:`chunked_scan` runs
the steps a block at a time; when ``chunk`` divides T (and T > chunk), each
block of ``chunk`` steps runs under ``torch.utils.checkpoint`` while a
gradient is recorded (the JAX ``jax.checkpoint(outer)``), so only the
blocks' boundary carries are saved for the backward pass (sqrt-remat).
Nested inside the LM's per-layer checkpoint, the blocks are recomputed
inside the layer's recompute.

``prep`` and ``post`` hoist the work that does not depend on the carry out
of the per-step body, inside the block's checkpoint, so the memory it takes
is one block's: ``prep`` maps a block of xs (leaves ``[c, ...]``) to the
block of per-step inputs the body reads, and ``post`` maps (that block, the
block's stacked ys) to the block's ys.  A recurrence then launches only its
update a step (the body returns the state its output reads as its y), and
the products that read the states run once a block, batched over its
steps.  The same operations run on the same values as they would inside the
body; a batched product may sum in another order than one a step.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..core.tree import flatten, tree_map, unflatten

BLOCK = 256      # steps a block when ``chunk`` does not apply (prep's memory)


def chunked_scan(body: Callable, carry: Any, xs: Any, *, chunk: int = 0,
                 remat: bool = True, prep: Callable | None = None,
                 post: Callable | None = None) -> tuple[Any, Any]:
    """``lax.scan(body, carry, xs)`` with chunked remat → (carry, ys).

    ``xs`` leaves are [T, ...]; ``body(carry, x_t) -> (carry, y_t)``; the
    ys are stacked to [T, ...].  ``chunk`` must divide T and be below it
    for the blocks to be checkpointed (0 → a plain loop); ``remat=False``
    runs the same blocks without checkpoints.  ``prep`` and ``post``
    (optional) hoist a block's carry-free work, as the module docstring
    says."""
    flat, treedef = flatten(xs)
    T = flat[0].shape[0]
    chunked = bool(chunk) and T % chunk == 0 and T > chunk
    block = chunk if chunked else BLOCK

    def run(c, lo: int, hi: int):
        xb = unflatten(treedef, [a[lo:hi] for a in flat])
        if prep is not None:
            xb = prep(xb)
        cols, tdef = flatten(xb)
        flat_tuple = tdef.kind == "tuple" and all(
            d.kind == "leaf" for d in tdef.children)
        ys = []
        for step in zip(*(a.unbind(0) for a in cols)):
            c, y = body(c, step if flat_tuple else unflatten(tdef, list(step)))
            ys.append(y)
        ys = tree_map(lambda *a: torch.stack(a), *ys)
        return c, (ys if post is None else post(xb, ys))

    save = chunked and remat and torch.is_grad_enabled()
    parts = []
    for lo in range(0, T, block):
        hi = min(lo + block, T)
        if save:
            carry, ys = checkpoint(run, carry, lo, hi, use_reentrant=False)
        else:
            carry, ys = run(carry, lo, hi)
        parts.append(ys)
    if len(parts) == 1:
        return carry, parts[0]
    return carry, tree_map(lambda *a: torch.cat(a), *parts)
