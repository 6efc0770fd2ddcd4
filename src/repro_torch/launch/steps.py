"""The training step — the port of the JAX package's ``launch/steps.py``
``make_train_step``, without a mesh.

One step: the LM's forward (per-layer remat, optional ``scan_chunks``) and
chunked cross-entropy, plus ``1e-2 * load_balance_loss + 1e-3 *
router_z_loss`` for a moe config, their gradient by autograd (every
self-attention's backward on K8 and K9 on the card), then AdamW with
clipping and the cosine schedule, in place.  The JAX module's
``batch_structs``, sharding helpers and serve steps wait for the sharding
slice.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core.tree import flatten, unflatten
from ..models import LM
from ..models.config import ArchConfig
from ..optim import adamw_update, cosine_schedule

Params = Any


def loss_and_grads(model: LM, params: Params, batch: dict, *,
                   remat: bool = True, scan_chunks: int = 0,
                   loss_chunk: int = 512
                   ) -> tuple[torch.Tensor, list[torch.Tensor], dict]:
    """The JAX ``loss_fn`` under ``value_and_grad``: (the cross-entropy,
    the gradient of the total loss for each leaf of ``params`` in
    :func:`~repro_torch.core.tree.flatten`'s order, aux).  The total is the
    cross-entropy, plus ``1e-2 * load_balance_loss + 1e-3 *
    router_z_loss`` for a moe config; aux holds ``LM.apply``'s aux summed
    over the layers and the ``total``, detached.  ``params`` are left
    without ``requires_grad``."""
    cfg = model.cfg
    flat, _ = flatten(params)
    kw = {"embeds": batch["embeds"]} if cfg.embeds_in else {}
    try:
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            h, aux = model.apply(params, batch.get("ids"), remat=remat,
                                 scan_chunks=scan_chunks, **kw)
            ce = model.loss(params, h, batch["labels"], batch["mask"],
                            chunk=loss_chunk)
            total = ce
            if cfg.n_experts:
                total = (total + 1e-2 * aux["load_balance_loss"]
                         + 1e-3 * aux["router_z_loss"])
            grads = torch.autograd.grad(total, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    aux = {k: v.detach() for k, v in {**aux, "total": total}.items()}
    return ce.detach(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(flat, grads)], aux


def make_train_step(cfg: ArchConfig, *, scan_chunks: int = 0,
                    lr: float = 3e-4, warmup: int = 200,
                    total_steps: int = 20000, remat: bool = True,
                    loss_chunk: int = 512):
    """→ (model, ``train_step(state, batch)``).

    ``state`` is ``{"params", "opt"}`` (:func:`~repro_torch.optim.adamw_init`),
    ``batch`` a dict of tensors on the parameters' device: ``labels`` and
    ``mask`` [B, S], and ``ids`` [B, S] (or ``embeds`` [B, S, d] for a
    model that takes embeddings).  ``train_step`` updates the state's tensors
    in place and returns (state, metrics): ``loss`` (the cross-entropy),
    ``grad_norm`` and ``lr``, and for a moe config ``dropped_frac`` (summed
    over the layers, as the JAX step reports it), as 0-d tensors on the
    device.
    """
    model = LM(cfg)
    sched = cosine_schedule(lr, warmup, total_steps)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        ce, grads, aux = loss_and_grads(model, params, batch, remat=remat,
                                        scan_chunks=scan_chunks,
                                        loss_chunk=loss_chunk)
        params, opt, om = adamw_update(unflatten(flatten(params)[1], grads),
                                       state["opt"], params, lr=sched)
        metrics = {"loss": ce, **om}
        if cfg.n_experts:
            metrics["dropped_frac"] = aux["dropped_frac"]
        return {"params": params, "opt": opt}, metrics

    return model, train_step
