"""Step builders and abstract input specs — the port of the JAX package's
``launch/steps.py``.

The train step: the LM's forward (per-layer remat, optional
``scan_chunks``) and chunked cross-entropy, plus ``1e-2 *
load_balance_loss + 1e-3 * router_z_loss`` for a moe config, their
gradient by autograd (every self- and cross-attention's backward on K8 and
K9 on the card), then AdamW with clipping and the cosine schedule, in
place.  The serve steps: :func:`make_prefill_step` (the full forward, the
last token's logits) and :func:`make_decode_step` (one token against a
cache, updated in place).

Given a mesh layout, each builder registers it
(:func:`~repro_torch.models.layers.set_attention_mesh`, which the anchors
and ``moe_groups`` read), and the train and decode steps re-anchor each
layer's weights to their storage spec without the "data" axis
(:func:`_layer_param_constraint`); the train step also anchors the layer
carry to the sequence-parallel spec.  On plain tensors (one process
holding the model whole) every anchor is the identity, and the layout
still sets the MoE routing groups.

Tensor-parallel serving across ranks (the dense family and its audio
variant, and the moe family with its experts split over the same axis:
expert parallelism, :mod:`repro_torch.models.moe`; a ``(1, model)``
mesh of :func:`~repro_torch.launch.mesh.run_on_local_mesh`): the serve
steps take weights as DTensors by ``param_shardings_serving``
(:func:`~repro_torch.launch.sharding.distribute_params` of a tree held
whole) and a cache by ``cache_shardings`` (:func:`init_cache_sharded`),
and every rank runs its shard (:mod:`repro_torch.models.layers`); the
logits come back whole on every rank, and decode writes each rank's part
of the new K/V into its shard of the cache in place.  Tensor-parallel
training (the same families and mesh): the train step takes a state of
:func:`init_train_state_sharded` (params by ``param_shardings``, moments
by ``opt_shardings``), every rank computes its shard's forward, recompute
and backward (K7, K8 and K9 on its local heads), and the gradients come
back as DTensors laid out as the params; with ``seq_parallel`` the layer
carry is each rank's part of the tokens (a moe block gathers them to route
every token).  A moe model's experts and their moments are the rank's E/m
(``[E/m, d, 2, ff]`` and ``[E/m, ff, d]`` a layer), the router and its
moments whole on every rank; ``global_norm`` sums the experts' squares
over the ranks once and counts the router's once.  The ssm, hybrid and vlm
families, a data axis over more than one rank and ``scan_chunks`` are
refused (:func:`_check_sharded`).

The abstract trees (:func:`abstract_params`, :func:`abstract_cache`) are
meta tensors, drawing and allocating nothing; :func:`batch_structs`,
:func:`with_shardings`, :func:`train_state_structs` and
:func:`serve_structs` give :class:`TensorStruct` records (shape, dtype and
sharding, the JAX ``ShapeDtypeStruct``).  XLA's scan ``unroll`` has no
counterpart: the layers are a Python loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..core.spmd_pipeline import is_dtensor, like_dtensor, local_tensor
from ..core.tree import flatten, leaves, tree_map, unflatten
from ..models import LM
from ..models.config import ArchConfig, ShapeConfig
from ..models.layers import NO_DRAW, SeqParallel, set_attention_mesh
from ..models.transformer import torch_dtype
from ..optim import adamw_init, adamw_update, cosine_schedule
from .sharding import (NamedSharding, P, batch_spec, cache_shardings,
                       distribute_params, drop_data, guard_spec, local_shape,
                       map_with_path, opt_shardings, param_shardings,
                       param_shardings_serving, param_spec, to_dtensor,
                       with_spec)

Params = Any


def _layer_param_constraint(mesh):
    """Constraint for a sliced layer's weights: the storage rules with the
    "data" (FSDP) axis dropped — gathered on data, still sharded on model.
    A plain tensor passes unchanged."""

    def con(lp):
        return map_with_path(
            lambda path, a: with_spec(a, drop_data(param_spec(mesh, path, a))),
            lp)

    return con


def _act_constraint(mesh) -> SeqParallel:
    """The layer carry anchored to ``act_spec`` (sequence parallel): a
    plain carry passes unchanged; under DTensor weights ``LM.apply`` keeps
    each rank's part of the tokens between layers."""
    return SeqParallel(mesh)


# --------------------------------------------------------------------------- #
# batch specs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TensorStruct:
    """A tensor's shape, dtype and sharding, with no data."""

    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding | None = None


def batch_structs(cfg: ArchConfig, shape: ShapeConfig, mesh=None) -> dict:
    B, S = shape.global_batch, shape.seq_len
    bs = (NamedSharding(mesh, guard_spec(mesh, batch_spec(mesh), (B, S)))
          if mesh is not None else None)
    dt = torch_dtype(cfg.dtype)

    def tok3(s):  # [B, s, d] embeds sharding
        if mesh is None:
            return None
        b = batch_spec(mesh)[0]
        return NamedSharding(
            mesh, guard_spec(mesh, P(b, None, None), (B, s, cfg.d_model)))

    out: dict = {}
    if shape.kind == "train":
        out["labels"] = TensorStruct((B, S), torch.int32, bs)
        out["mask"] = TensorStruct((B, S), torch.float32, bs)
    if shape.kind in ("train", "prefill"):
        if cfg.embeds_in:
            out["embeds"] = TensorStruct((B, S, cfg.d_model), dt, tok3(S))
        else:
            out["ids"] = TensorStruct((B, S), torch.int32, bs)
        if cfg.cross_attn_every:
            out["img_embeds"] = TensorStruct(
                (B, cfg.n_img_tokens, cfg.d_model), dt,
                tok3(cfg.n_img_tokens))
        return out
    # decode: one new token against a seq_len cache
    out["pos"] = TensorStruct((), torch.int32, NamedSharding(mesh, P())
                              if mesh is not None else None)
    if cfg.embeds_in:
        out["embeds"] = TensorStruct((B, 1, cfg.d_model), dt, tok3(1))
    else:
        out["ids"] = TensorStruct((B, 1), torch.int32, bs)
    return out


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree as meta tensors (nothing drawn or allocated)."""
    return LM(cfg).init(NO_DRAW)


def abstract_cache(cfg: ArchConfig, batch: int, cache_len: int) -> Params:
    """The cache tree as meta tensors."""
    return LM(cfg).init_cache(batch, cache_len, device="meta")


def with_shardings(mesh, tree: Params, shardings: Params) -> Params:
    """A tree of :class:`TensorStruct` from a tree of tensors (or structs)
    and its tree of shardings."""
    del mesh
    return tree_map(lambda s, sh: TensorStruct(tuple(s.shape), s.dtype, sh),
                    tree, shardings)


# --------------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------------- #
def loss_and_grads(model: LM, params: Params, batch: dict, *,
                   remat: bool = True, scan_chunks: int = 0,
                   loss_chunk: int = 512, act_constraint=None,
                   param_constraint=None
                   ) -> tuple[torch.Tensor, list[torch.Tensor], dict]:
    """The JAX ``loss_fn`` under ``value_and_grad``: (the cross-entropy,
    the gradient of the total loss for each leaf of ``params`` in
    :func:`~repro_torch.core.tree.flatten`'s order — DTensors laid out as
    their params where those are DTensors — aux).  The total is the
    cross-entropy, plus ``1e-2 * load_balance_loss + 1e-3 *
    router_z_loss`` for a moe config; aux holds ``LM.apply``'s aux summed
    over the layers and the ``total``, detached.  ``params`` are left
    without ``requires_grad``."""
    cfg = model.cfg
    flat, _ = flatten(params)
    kw = {"embeds": batch["embeds"]} if cfg.embeds_in else {}
    if cfg.cross_attn_every:
        kw["img_embeds"] = batch["img_embeds"]
    try:
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            h, aux = model.apply(params, batch.get("ids"), remat=remat,
                                 act_constraint=act_constraint,
                                 param_constraint=param_constraint,
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
    return ce.detach(), [like_dtensor(torch.zeros_like(local_tensor(p)), p)
                         if g is None else g for p, g in zip(flat, grads)], aux


def make_train_step(cfg: ArchConfig, mesh=None, *, scan_chunks: int = 0,
                    seq_parallel: bool = True, lr: float = 3e-4,
                    warmup: int = 200, total_steps: int = 20000,
                    remat: bool = True, loss_chunk: int = 512):
    """→ (model, ``train_step(state, batch)``).

    ``mesh``: a layout to register and anchor to (the module docstring);
    ``seq_parallel`` anchors the layer carry to ``act_spec`` too
    (:class:`~repro_torch.models.layers.SeqParallel`: under DTensor weights
    each rank keeps its part of the tokens between layers).

    ``state`` is ``{"params", "opt"}`` (:func:`~repro_torch.optim.adamw_init`),
    ``batch`` a dict of tensors on the parameters' device: ``labels`` and
    ``mask`` [B, S], and ``ids`` [B, S] (or ``embeds`` [B, S, d] for a
    model that takes embeddings), plus ``img_embeds`` [B, n_img_tokens, d]
    in the config's dtype for a vlm model.  ``train_step`` updates the
    state's tensors in place and returns (state, metrics): ``loss`` (the
    cross-entropy), ``grad_norm`` and ``lr``, and for a moe config
    ``dropped_frac`` (summed over the layers, as the JAX step reports it),
    as 0-d tensors on the device.
    """
    model = LM(cfg)
    sched = cosine_schedule(lr, warmup, total_steps)
    con = pcon = None
    if mesh is not None:
        set_attention_mesh(mesh)
        pcon = _layer_param_constraint(mesh)
        if seq_parallel:
            con = _act_constraint(mesh)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        _check_sharded(cfg, params, scan_chunks=scan_chunks)
        ce, grads, aux = loss_and_grads(model, params, batch, remat=remat,
                                        scan_chunks=scan_chunks,
                                        loss_chunk=loss_chunk,
                                        act_constraint=con,
                                        param_constraint=pcon)
        params, opt, om = adamw_update(unflatten(flatten(params)[1], grads),
                                       state["opt"], params, lr=sched)
        metrics = {"loss": ce, **om}
        if cfg.n_experts:
            metrics["dropped_frac"] = aux["dropped_frac"]
        return {"params": params, "opt": opt}, metrics

    return model, train_step


def train_state_structs(cfg: ArchConfig, mesh):
    """(``{"params", "opt"}`` of :class:`TensorStruct`, their shardings)."""
    params = abstract_params(cfg)
    opt = adamw_init(params)
    ps = param_shardings(mesh, params)
    os_ = opt_shardings(mesh, opt, params)
    state = {"params": with_shardings(mesh, params, ps),
             "opt": type(opt)(step=with_shardings(mesh, opt.step, os_.step),
                              m=with_shardings(mesh, opt.m, os_.m),
                              v=with_shardings(mesh, opt.v, os_.v))}
    return state, {"params": ps, "opt": os_}


def init_train_state_sharded(cfg: ArchConfig, mesh, params: Params) -> dict:
    """``{"params", "opt"}`` for tensor-parallel training on a ``(1,
    model)`` mesh from a params tree held whole on every rank (drawn from
    one seed, or converted): each rank keeps its shard of each leaf by
    :func:`param_shardings` (:func:`distribute_params`) and allocates its
    moments at their local shapes (:func:`adamw_init`, laid out as the
    parameters: :func:`opt_shardings`)."""
    sharded = distribute_params(mesh, params, param_shardings(mesh, params))
    _check_sharded(cfg, sharded)
    return {"params": sharded, "opt": adamw_init(sharded)}


# --------------------------------------------------------------------------- #
# serve steps
# --------------------------------------------------------------------------- #
def init_cache_sharded(cfg: ArchConfig, mesh, batch: int,
                       cache_len: int) -> Params:
    """``LM(cfg).init_cache``'s zero cache as DTensors by
    ``cache_shardings``: each rank allocates its shard alone, on its
    device."""
    whole = abstract_cache(cfg, batch, cache_len)
    return tree_map(
        lambda w, sh: to_dtensor(mesh, torch.zeros(
            local_shape(mesh, sh.spec, w.shape), dtype=w.dtype,
            device=mesh.device), sh.spec, w.shape),
        whole, cache_shardings(mesh, cfg, whole))


# the families whose blocks run on a rank's shard: the dense one, the
# audio family (the dense backbone over given embeddings), and the moe
# family (its attention on the rank's heads, its experts on the rank's E/m)
TP_FAMILIES = ("dense", "audio", "moe")


def _check_sharded(cfg: ArchConfig, params: Params, *,
                   scan_chunks: int = 0) -> None:
    """Refuse DTensor weights where tensor parallelism is not done: a
    family other than the dense one, its audio variant and the moe one, a
    mesh axis other than ``model`` of more than one rank, and (the train
    step, which passes ``scan_chunks``) chunked remat."""
    w = leaves(params)[0]
    if not is_dtensor(w):
        return
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: tensor parallelism runs the dense family (and "
            f"audio, its backbone) and expert parallelism the moe family; "
            f"the {cfg.family} family under a model axis is not done here")
    dm = w.device_mesh
    other = {n: dm.size(i) for i, n in enumerate(dm.mesh_dim_names)
             if n != "model" and dm.size(i) > 1}
    if other:
        raise NotImplementedError(f"tensor parallelism takes a "
                                  f"(1, model) mesh, not one with {other}")
    if scan_chunks:
        raise NotImplementedError(f"scan_chunks={scan_chunks} under a model "
                                  f"axis is not done here")


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """→ (model, ``prefill_step(params, batch)``): the full forward without
    a cache and the last token's logits [B, 1, vocab] f32 (whole on every
    rank when ``params`` are DTensors, the module docstring)."""
    model = LM(cfg)
    if mesh is not None:
        set_attention_mesh(mesh)

    @torch.no_grad()
    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        _check_sharded(cfg, params)
        kw = {}
        if cfg.embeds_in:
            kw["embeds"] = batch["embeds"]
        if cfg.cross_attn_every:
            kw["img_embeds"] = batch["img_embeds"]
        h, _ = model.apply(params, batch.get("ids"), remat=False, **kw)
        return model.logits(params, h[:, -1:])

    return model, prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """→ (model, ``serve_step(params, cache, batch)``): one token for every
    sequence at ``batch["pos"]``; returns (logits, the cache, updated in
    place)."""
    model = LM(cfg)
    pcon = _layer_param_constraint(mesh) if mesh is not None else None
    if mesh is not None:
        set_attention_mesh(mesh)

    @torch.no_grad()
    def serve_step(params: Params, cache: Params, batch: dict):
        _check_sharded(cfg, params)
        kw = {"embeds": batch["embeds"]} if cfg.embeds_in else {}
        return model.decode_step(params, batch.get("ids"), cache,
                                 int(batch["pos"]), param_constraint=pcon,
                                 **kw)

    return model, serve_step


def serve_structs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                  serving_layout: bool = False) -> dict:
    """The params (and for decode the cache) as :class:`TensorStruct`
    trees with their shardings; ``serving_layout``: TP-only weights."""
    params = abstract_params(cfg)
    ps = (param_shardings_serving(mesh, params) if serving_layout
          else param_shardings(mesh, params))
    out = {"params": with_shardings(mesh, params, ps), "param_shardings": ps}
    if shape.kind == "decode":
        cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cs = cache_shardings(mesh, cfg, cache)
        out["cache"] = with_shardings(mesh, cache, cs)
        out["cache_shardings"] = cs
    return out
