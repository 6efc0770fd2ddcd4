"""Decoder-only LM — the port of the JAX package's ``models/transformer.py``
for every family.

Families: ``dense`` (GQA attention + SwiGLU: deepseek-67b, gemma3-12b,
gemma3-27b, mistral-large-123b), ``audio`` (musicgen-large: the same
dense backbone over precomputed frame embeddings, ``embeds_in``), ``moe``
(GQA attention + a top-k expert FFN, :mod:`.moe`: moonshot-v1-16b-a3b,
qwen3-moe-235b-a22b), ``hybrid`` (GQA attention and a selective-SSM branch
in parallel, averaged, :mod:`.ssm`: hymba-1.5b), ``ssm`` (RWKV-6 blocks,
attention-free, :mod:`.rwkv`: rwkv6-1.6b) and ``vlm`` (llama-3.2-vision-11b:
groups of ``cross_attn_every - 1`` self-attention layers and one
cross-attention layer over precomputed image embeddings, ``img_embeds``
[B, n_img_tokens, d] in the config's dtype).

The JAX ``lax.scan`` over the stacked ``[L, ...]`` parameters is a Python
loop over the same stacked tensors; per-layer heterogeneity (gemma3's
sliding window and rope theta) rides along as per-layer data, so the
parameter tree has the JAX tree's layout and :func:`params_from_numpy`
carries JAX weights across unchanged (for vlm: ``layers`` ``[G, per, ...]``
and ``cross`` ``[G, ...]``).  The cache is updated in place: the k/v rows
by the attention, a layer's recurrent state (the hybrid block's ``ssm``
``h``/``conv``, the rwkv block's ``S``/``tm_last``/``cm_last``) copied into
its ``[L, ...]`` stack after the layer runs, and the vlm cache's image K/V
(``cross`` ``ck``/``cv``) written once by the prefill and read by decode.

Training: ``apply(remat=True)`` checkpoints every layer with
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` body), and with
``scan_chunks=c`` every chunk of c layers as well (the JAX nested-remat
scan); the recurrences' time-chunk checkpoints (:mod:`.scan_utils`) nest
inside them.  The nest is the same under DTensor weights, a
sequence-parallel carry and a batch split over ``data`` (or ``pod`` and
``data``): a layer's ``data`` gather runs inside its checkpoint, so each
recompute that reaches the layer gathers it again, while its gradient is
summed back once a step (the forward's graph is the one differentiated).
A chunk's recompute stops once the chunk's saved tensors are back (torch's
early stop: its first c - 1 layers, the last layer's input being the
last of them), and it stops at the same op on every rank (:func:`_remat`).
A vlm model checkpoints each group instead, as the JAX ``_apply_vlm``
does, and ignores ``scan_chunks``.  :meth:`LM.loss` is the chunked cross-entropy, one
checkpointed chunk of ``[B, chunk, V]`` f32 logits alive at a time; over a
vocab-sharded table (tensor parallelism) each rank's chunk holds the
logits of its rows only (:func:`_chunk_nll_sharded`).  Under DTensor
weights and a :class:`~repro_torch.models.layers.SeqParallel`
``act_constraint``, :meth:`LM.apply` keeps each rank's part of the tokens
between layers and gathers the final norm's output.

A batch split over a data axis (its tensors DTensors whose dim 0 is split,
:func:`~repro_torch.launch.sharding.distribute_batch`): every rank
computes its own rows, each layer's weights and the embedding table
gathered over ``data`` as they are read
(:func:`~repro_torch.models.layers.gather_data`), their gradient summed
back over it; :meth:`LM.loss` sums the masked losses and token counts over
the axis before it divides, so every rank holds (and back-propagates once)
the global batch's mean; the moe blocks route by the global batch's
groups.  Hidden states, logits and the cache are the rank's rows, plain
tensors; a batch whole on every rank (a plain tensor, or one the guard
left whole) is computed whole, the gathers' gradients kept, not summed.

The vlm blocks mark their card time for the profiler: ``vlm:self``,
``vlm:cross`` (the attentions), ``vlm:mlp`` and ``vlm:cross_kv`` (the
prefill's image K/V).
"""
from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..core.placement import resolve_device
from ..core.spmd_pipeline import (all_gather_cat, all_reduce_sum,
                                   batch_line, copy_to_ranks, is_dtensor,
                                   local_bounds, local_tensor, own_part,
                                   reduce_over_ranks, unbind_layers)
from ..core.tree import flatten, tree_map, unflatten
from ..kernels import ops
from .config import ArchConfig
from .layers import (SeqParallel, _cache_part, _cache_read, _con_heads,
                     _cut, _kv_for_heads, _local, _model_line,
                     _row_parallel, _state_rows, attention, attention_init,
                     embed, embed_init, gather_data, gqa_combine, gqa_scores,
                     lm_logits, logits_f32, mlp, mlp_init, rmsnorm,
                     rmsnorm_init)
from .moe import AUX_KEYS, moe_apply, moe_init
from .rwkv import rwkv_block, rwkv_init, rwkv_init_state
from .ssm import ssm_apply, ssm_init, ssm_init_state

Params = Any


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16``."""
    return getattr(torch, name)


# =========================================================================== #
# Per-layer block
# =========================================================================== #
def _block_init(cfg: ArchConfig, generator: torch.Generator,
                cross: bool = False) -> Params:
    """One block's weights; a cross-attention block (``cross``) has an MLP,
    never experts."""
    dtype = torch_dtype(cfg.dtype)
    dev = generator.device
    p = {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
         "ln2": rmsnorm_init(cfg.d_model, dtype, dev)}
    if cfg.rwkv:
        p["rwkv"] = rwkv_init(generator, cfg.d_model, cfg.d_ff, dtype)
        return p
    p["attn"] = attention_init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.hd, dtype)
    if cfg.hybrid:
        p["ssm"] = ssm_init(generator, cfg.d_model, cfg.ssm_state,
                            cfg.conv_kernel, dtype)
    if cfg.n_experts and not cross:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            dtype)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def _zero_aux(device=None) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _range(cfg: ArchConfig, name: str):
    """A profiler range around a vlm block's part (nothing elsewhere)."""
    return (record_function(name) if cfg.cross_attn_every
            else contextlib.nullcontext())


def _block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                 window: int, theta: float, cache: Params | None = None,
                 cache_pos: int | None = None,
                 img_kv: torch.Tensor | Params | None = None,
                 is_cross: bool = False, seq: bool = False,
                 data: tuple | None = None
                 ) -> tuple[torch.Tensor, Params | None, dict | None]:
    """One block. Returns (x, new_cache, aux); aux is None but for a moe
    block (the JAX block's zeros).  ``seq``: ``x`` is this rank's part of
    the tokens (:class:`~repro_torch.models.layers.SeqParallel`; a dense
    or moe block: the moe block gathers the tokens along S to route them
    all, :func:`~repro_torch.models.moe.moe_apply`), and so is the result.
    new_cache: the rwkv state, or the attention's k/v (the cache's own
    tensors, written in place) and the hybrid block's new ``ssm`` state;
    None without a cache, and always None for a cross block (``is_cross``),
    which attends to ``img_kv``: raw image embeddings [B, M, d], or a dict
    of the cached ``ck``/``cv`` (:func:`_cross_from_cache`).  ``data``: x
    is this rank's rows of a batch split over the data axis (the moe
    block's routing groups are the global batch's; a recurrent state and
    the image K/V must hold the same rows, a k/v cache the same rows or
    every row: :func:`~repro_torch.models.layers.attention`)."""
    if cfg.rwkv:
        x, new_state = rwkv_block(p["rwkv"], x, p["ln1"], p["ln2"],
                                  state=cache, seq=seq, data=data)
        return x, new_state, None
    h = rmsnorm(p["ln1"], x, split=seq)
    if is_cross:
        with _range(cfg, "vlm:cross"):
            if isinstance(img_kv, dict):
                a = _cross_from_cache(p, h, img_kv, prefill=cache_pos == 0,
                                      data=data)
            else:
                a, _ = attention(p["attn"], h, None, theta=theta,
                                 kv_x=img_kv, seq=seq)
        new_cache = None
    else:
        kv = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        with _range(cfg, "vlm:self"):
            a, new_cache = attention(p["attn"], h, None, theta=theta,
                                     window=window, cache=kv,
                                     cache_pos=cache_pos, seq=seq, data=data)
    if cfg.hybrid:
        s, s_new = ssm_apply(p["ssm"], h,
                             state=None if cache is None else cache["ssm"],
                             seq=seq, data=data)
        a = (a + s) * 0.5
        if new_cache is not None:
            new_cache["ssm"] = s_new
    x = x + a
    h2 = rmsnorm(p["ln2"], x, split=seq)
    if "moe" in p:
        y, aux = moe_apply(p["moe"], h2, cfg.top_k, cfg.moe_capacity_factor,
                           seq=seq, data=data)
    else:
        with _range(cfg, "vlm:mlp"):
            y, aux = mlp(p["mlp"], h2, seq=seq), None
    return x + y, new_cache, aux


def _cross_from_cache(p: Params, h: torch.Tensor, img_kv: Params, *,
                      prefill: bool, data=None) -> torch.Tensor:
    """Cross-attention of ``h`` [B, T, d] against the cached image K/V
    (``ck``/``cv`` [B, M, KV, hd]), unmasked: through K7 with
    ``causal=False`` in a prefill, a plain softmax in decode (T = 1, where
    K7's 128-row query tile has one row to fill), as the JAX function.
    Under a model axis, q of this rank's heads against their kv heads (the
    cache gathered along head_dim where it is split), then its rows of
    ``wo`` (:func:`~repro_torch.models.layers.attention`'s split).  The
    image K/V must hold the rows of ``h``, split over ``data`` as they are
    (:func:`~repro_torch.models.layers._state_rows`)."""
    wq, wo = p["attn"]["wq"], p["attn"]["wo"]
    for n in ("ck", "cv"):
        _state_rows(img_kv[n], h.shape[0], data, "image K/V cache")
    H, hd = wq.shape[1], wq.shape[2]
    heads, rows = local_bounds(wq)[1], local_bounds(wo)[0]
    q = _con_heads(torch.einsum("btd,dnh->btnh", h, _local(wq)))
    B, T, Hl, _ = q.shape
    G = H // img_kv["ck"].shape[2]
    (k, kv_lo), (v, _) = _cache_read(img_kv["ck"]), _cache_read(img_kv["cv"])
    k = _con_heads(_kv_for_heads(k, kv_lo, heads, G))
    v = _con_heads(_kv_for_heads(v, kv_lo, heads, G))
    if prefill:
        out = ops.attention(q, k, v, False, 0).reshape(B, T, Hl * hd)
    else:
        probs = torch.softmax(gqa_scores(q, k), dim=-1).to(h.dtype)
        out = gqa_combine(probs, v)
    out = _cut(out, 2, rows.start - heads.start * hd,
               rows.stop - heads.start * hd)
    return _row_parallel(out, wo)


def _unstack(tree: Params, dims: int = 1) -> list[Params]:
    """The layers of a stacked ``[L, ...]`` tree (or, ``dims=2``, of a
    ``[G, per, ...]`` one, in the order g * per + j; views, no copies): one
    ``unbind`` per leaf, so autograd stacks the layers' gradients once.  A
    DTensor leaf (tensor-parallel serving) gives DTensors, views of its
    local tensor; one whose stack dim is split over the data axis (the vlm
    self cache's ``per``) a
    :class:`~repro_torch.core.spmd_pipeline.HeldBy` record a layer
    (:func:`~repro_torch.core.spmd_pipeline.unbind_layers`)."""
    flat, treedef = flatten(tree)
    cols = [unbind_layers(a, dims) if is_dtensor(a)
            else a.flatten(0, dims - 1).unbind(0) for a in flat]
    return [unflatten(treedef, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def _write_back(dst: Params, src: Params) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors (views of the stacked
    cache), skipping those that already are ``dst``'s; a DTensor of a
    sharded cache takes its rank's part (``src``'s leaf is that part) into
    its local tensor."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_back(dst[k], v)
        elif v is not dst[k]:
            local_tensor(dst[k]).copy_(v)


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    JAX ``jax.checkpoint``); a plain call where no gradient is recorded.
    Non-reentrant, with torch's early stop (a recompute ends once the
    tensors the backward needs are back): across ranks a recompute that
    stopped before a collective on one rank and after it on another would
    hang the group, but every rank runs the same ops and saves the same
    sequence of tensors (no branch on the path depends on a rank's data),
    so each recompute stops at the same op on every rank."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _chunk_nll(h: torch.Tensor, table: torch.Tensor, t: torch.Tensor,
               m: torch.Tensor, vocab: int) -> torch.Tensor:
    """Masked negative log-likelihood summed over one [B, chunk] chunk."""
    B, c, d = h.shape
    logits = logits_f32(h.reshape(B * c, d), table)[:, :vocab]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, t.reshape(B * c, 1).long())[:, 0]
    return ((lse - gold) * m.reshape(B * c)).sum()


def _chunk_nll_sharded(h: torch.Tensor, rows: torch.Tensor, lo: int,
                       t: torch.Tensor, m: torch.Tensor, vocab: int, group,
                       transport: str) -> torch.Tensor:
    """:func:`_chunk_nll` over this rank's vocab rows ``rows`` (global rows
    ``lo..``) of the table, Megatron's vocab-parallel cross-entropy: the
    rank's logits only, the padded rows beyond ``vocab`` masked; the max
    taken over the model axis, then the sums of exps and the gold logits
    summed over it in f32 (small all-reduces of [2, N]), so no [N, vocab]
    logits are gathered.  Every rank returns the whole chunk's sum."""
    B, c, d = h.shape
    N, V = B * c, rows.shape[0]
    logits = logits_f32(h.reshape(N, d), rows)
    cols = lo + torch.arange(V, device=logits.device)
    logits = logits.masked_fill(cols >= vocab, float("-inf"))
    with torch.no_grad():
        mx = reduce_over_ranks(logits.max(-1).values, group, transport,
                               op="max")
    sumexp = torch.exp(logits - mx[:, None]).sum(-1)
    at = t.reshape(N).long() - lo
    mine = (at >= 0) & (at < V)
    gold = torch.gather(logits, 1, torch.where(mine, at, 0)[:, None])[:, 0]
    gold = torch.where(mine, gold, torch.zeros((), device=gold.device))
    sumexp, gold = all_reduce_sum(torch.stack([sumexp, gold]), group,
                                  transport)
    lse = mx + torch.log(sumexp)
    return ((lse - gold) * m.reshape(N)).sum()


# =========================================================================== #
# The model
# =========================================================================== #
class LM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # -- params -------------------------------------------------------------- #
    def init(self, generator: torch.Generator) -> Params:
        """Random weights on the generator's device, in the config's dtype;
        meta tensors of the same tree, drawing nothing, given
        :data:`~repro_torch.models.layers.NO_DRAW`."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        params: dict = {
            "embed": embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device),
        }
        if cfg.cross_attn_every:
            n_groups, per = self._vlm_groups()
            layers = [_block_init(cfg, generator)
                      for _ in range(n_groups * per)]
            params["layers"] = tree_map(
                lambda *a: torch.stack(a).unflatten(0, (n_groups, per)),
                *layers)
            cross = [_block_init(cfg, generator, cross=True)
                     for _ in range(n_groups)]
            params["cross"] = tree_map(lambda *a: torch.stack(a), *cross)
            return params
        layers = [_block_init(cfg, generator) for _ in range(cfg.n_layers)]
        params["layers"] = tree_map(lambda *a: torch.stack(a), *layers)
        return params

    def _vlm_groups(self) -> tuple[int, int]:
        """(groups, self layers a group) of a vlm config."""
        cfg = self.cfg
        per = cfg.cross_attn_every
        if cfg.n_layers % per:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                             f"cross_attn_every {per}")
        return cfg.n_layers // per, per - 1

    def _layer_meta(self) -> list[tuple[int, float]]:
        """(window, rope theta) of each layer; of each self layer, in the
        order g * per + j, for a vlm config."""
        cfg = self.cfg
        keep = ~cfg.is_cross_layer
        return [(int(w), float(t)) for w, t in
                zip(cfg.layer_windows[keep], cfg.layer_thetas[keep])]

    def _img_in(self, img_embeds, rows: int, data) -> torch.Tensor:
        """This rank's rows of the vlm model's image embeddings, which must
        be the activations' ``rows`` (split over ``data`` as they are,
        :func:`~repro_torch.models.layers._state_rows`) and come in the
        config's dtype: a bf16 model's blocks take bf16 K/V, as the JAX
        trainer feeds them (an f32 draw breaks the JAX layer scan)."""
        want = torch_dtype(self.cfg.dtype)
        if img_embeds is None:
            raise ValueError(f"{self.cfg.arch_id}: the vlm family needs "
                             f"img_embeds [B, {self.cfg.n_img_tokens}, "
                             f"{self.cfg.d_model}]")
        if img_embeds.dtype != want:
            raise TypeError(f"{self.cfg.arch_id}: img_embeds are "
                            f"{img_embeds.dtype}, the model is {want}")
        _state_rows(img_embeds, rows, data, "image embeddings")
        return local_tensor(img_embeds)

    def _batch(self, ids, embeds) -> tuple | None:
        """The data axis's (process group, transport) where the batch's
        input is split over it
        (:func:`~repro_torch.core.spmd_pipeline.batch_line`), else None."""
        return batch_line(embeds if self.cfg.embeds_in else ids)

    def _embed_in(self, params: Params, ids, embeds,
                  data=None) -> torch.Tensor:
        """This rank's rows of the input, embedded (the table gathered over
        ``data`` first, :func:`~repro_torch.models.layers.gather_data`)."""
        if self.cfg.embeds_in:
            x = local_tensor(embeds)
        else:
            x = embed(gather_data(params["embed"], data), local_tensor(ids))
        return x.to(torch_dtype(self.cfg.dtype))

    # -- full-sequence forward ------------------------------------------------ #
    def apply(self, params: Params, ids: torch.Tensor | None = None, *,
              embeds: torch.Tensor | None = None,
              img_embeds: torch.Tensor | None = None, remat: bool = True,
              act_constraint=None, param_constraint=None,
              scan_chunks: int = 0) -> tuple[torch.Tensor, dict]:
        """→ (hidden [B, S, d], aux). Use :meth:`loss` / :meth:`logits`
        after.  aux: the MoE aux losses (``load_balance_loss``,
        ``router_z_loss``, ``dropped_frac``) summed over the layers, f32
        0-d tensors; zero for the other families.

        ``remat``: recompute each layer's activations in the backward pass
        (each group's, for a vlm model, which needs ``img_embeds``).
        ``scan_chunks=c``: also checkpoint each chunk of c layers (the JAX
        nested-remat scan), under DTensor weights too (the module
        docstring), ignored unless c divides ``n_layers``, and by a vlm
        model.  ``act_constraint``: a function applied to the embedded
        input and each layer's output (the sequence-parallel layout of
        :func:`repro_torch.launch.steps.make_train_step`); a
        :class:`~repro_torch.models.layers.SeqParallel` one under DTensor
        weights over a model axis dividing S keeps each rank's [B, S/m, d]
        part of the carry between layers (the dense blocks, the norms on
        the part, the final norm's output gathered);
        ``param_constraint``: one applied to each layer's weights before
        the layer runs, after their ``data`` dim is gathered.  ``ids`` or
        ``embeds`` may be DTensors split over a data axis (the module
        docstring): the hidden states are then this rank's rows."""
        cfg = self.cfg
        con = act_constraint or (lambda h: h)
        pcon = param_constraint or (lambda p: p)
        data = self._batch(ids, embeds)
        x = self._embed_in(params, ids, embeds, data)
        line = (SeqParallel.line(params["final_norm"]["scale"], x.shape[1])
                if isinstance(act_constraint, SeqParallel) else None)
        x = own_part(x, 1, *line) if line else con(x)
        seq = line is not None
        if cfg.cross_attn_every:
            x, aux = self._apply_vlm(
                params, x, self._img_in(img_embeds, x.shape[0], data), remat,
                con, pcon, seq, data)
        else:
            x, aux = self._apply_layers(params, x, remat, con, pcon, seq,
                                        scan_chunks, data)
        x = rmsnorm(params["final_norm"], x, split=seq)
        return (all_gather_cat(x, 1, *line) if line else x), aux

    def _apply_layers(self, params: Params, x: torch.Tensor, remat: bool,
                      con, pcon, seq: bool, scan_chunks: int, data=None
                      ) -> tuple[torch.Tensor, dict]:
        """The layer stack of :meth:`apply` (no vlm groups), before the
        final norm; each layer's weights gathered over ``data`` inside its
        checkpoint, so the backward gathers them again."""
        cfg = self.cfg
        layers = _unstack(params["layers"])
        meta = self._layer_meta()

        def layer(i: int, h: torch.Tensor
                  ) -> tuple[torch.Tensor, dict | None]:
            w, th = meta[i]
            h, _, aux = _block_apply(cfg, pcon(gather_data(layers[i], data)),
                                     h, window=w, theta=th, seq=seq,
                                     data=data)
            return con(h), aux

        def run(lo: int, hi: int, h: torch.Tensor, aux: dict
                ) -> tuple[torch.Tensor, dict]:
            for i in range(lo, hi):
                h, a = _remat(layer, i, h) if remat else layer(i, h)
                if a is not None:
                    aux = {k: aux[k] + a[k] for k in aux}
            return h, aux

        aux = _zero_aux(x.device)
        c = scan_chunks
        if remat and c and cfg.n_layers % c == 0:
            for lo in range(0, cfg.n_layers, c):
                x, aux = _remat(run, lo, lo + c, x, aux)
        else:
            x, aux = run(0, cfg.n_layers, x, aux)
        return x, aux

    def _apply_vlm(self, params: Params, x: torch.Tensor,
                   img_embeds: torch.Tensor, remat: bool, con, pcon,
                   seq: bool, data=None) -> tuple[torch.Tensor, dict]:
        """The vlm forward before the final norm: each group's self
        layers, then its cross layer over ``img_embeds`` (the rows of
        ``x``), one checkpoint a group (the JAX ``jax.checkpoint(group)``).
        ``seq``: ``x`` is this rank's part of the tokens, as in
        :meth:`apply`'s other layers; every layer's weights gathered over
        ``data`` inside the group's checkpoint, so the backward gathers
        them again, as :meth:`_apply_layers` gathers a layer."""
        cfg = self.cfg
        n_groups, per = self._vlm_groups()
        layers = _unstack(params["layers"], 2)
        cross = _unstack(params["cross"])
        meta = self._layer_meta()

        def group(g: int, h: torch.Tensor, aux: dict
                  ) -> tuple[torch.Tensor, dict]:
            for i in range(g * per, (g + 1) * per):
                w, th = meta[i]
                h, _, a = _block_apply(cfg, pcon(gather_data(layers[i], data)),
                                       h, window=w, theta=th, seq=seq,
                                       data=data)
                h = con(h)
                if a is not None:
                    aux = {k: aux[k] + a[k] for k in aux}
            h, _, _ = _block_apply(cfg, pcon(gather_data(cross[g], data)), h,
                                   window=0, theta=cfg.rope_theta,
                                   img_kv=img_embeds, is_cross=True, seq=seq,
                                   data=data)
            return con(h), aux

        aux = _zero_aux(x.device)
        for g in range(n_groups):
            x, aux = _remat(group, g, x, aux) if remat else group(g, x, aux)
        return x, aux

    def loss(self, params: Params, hidden: torch.Tensor,
             targets: torch.Tensor, mask: torch.Tensor | None = None,
             chunk: int = 512) -> torch.Tensor:
        """Mean next-token cross-entropy over the masked tokens, f32.

        As the JAX ``LM.loss``: ``S // chunk`` chunks (the tail tokens are
        dropped), logits of the embedding table (bf16 products summed in
        f32, f32 out; :func:`~repro_torch.models.layers.logits_f32`) sliced
        to the vocab; each chunk checkpointed, so one chunk's logits are
        alive at a time.  Over a vocab-sharded table (a DTensor) each rank
        takes the logits of its rows (:func:`_chunk_nll_sharded`), and
        ``hidden``'s gradient, a part on each rank, is summed over the
        model axis.  ``targets`` and ``mask`` split over a data axis
        (DTensors, ``hidden`` the rank's rows): the table is gathered over
        ``data``, and the loss and token sums are summed over the batch's
        line (``data``, or ``pod`` and ``data``) before the division, so
        every rank returns the global batch's mean, whose gradient is its
        rows' part (the sum's backward passes it as it is)."""
        data = batch_line(targets)
        hidden, targets = local_tensor(hidden), local_tensor(targets)
        mask = None if mask is None else local_tensor(mask)
        B, S, _ = hidden.shape
        chunk = min(chunk, S)
        table = gather_data(params["embed"], data)["table"]
        vocab, vb = self.cfg.vocab, local_bounds(table)[0]
        sharded = vb.stop - vb.start != table.shape[0]
        if sharded:                        # this rank's vocab rows
            line = _model_line(table)
            hidden = copy_to_ranks(hidden, *line)
            rows = table.to_local()
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for lo in range(0, S // chunk * chunk, chunk):
            sl = slice(lo, lo + chunk)
            t = targets[:, sl]
            m = (mask[:, sl].to(torch.float32) if mask is not None else
                 torch.ones(t.shape, dtype=torch.float32, device=t.device))
            if sharded:
                tot = tot + _remat(_chunk_nll_sharded, hidden[:, sl], rows,
                                   vb.start, t, m, vocab, *line)
            else:
                tot = tot + _remat(_chunk_nll, hidden[:, sl], _local(table),
                                   t, m, vocab)
            cnt = cnt + m.sum()
        if data is not None:                # the global batch's sums
            tot = all_reduce_sum(tot, *data)
            cnt = reduce_over_ranks(cnt, *data)
        return tot / torch.clamp(cnt, min=1.0)

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """[B, T, vocab] f32 logits of ``hidden`` (the table gathered over
        ``data`` first; serving, no gradient summed over it)."""
        return lm_logits(gather_data(params["embed"], None), hidden,
                         self.cfg.vocab)

    # -- KV cache / serving ----------------------------------------------------- #
    def init_cache(self, batch: int, cache_len: int, device=None) -> Params:
        """A zero cache on ``device`` (the card unless ``device="cpu"``),
        each leaf stacked ``[L, ...]``: k/v ``[B, cache_len, KV, hd]``, plus
        the hybrid block's ``ssm`` state; for rwkv the block state alone
        (``cache_len`` unused).  For vlm ``{"self": k/v [G, per, B,
        cache_len, KV, hd], "cross": ck/cv [G, B, n_img_tokens, KV, hd]}``."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        if cfg.rwkv:
            per = rwkv_init_state(batch, cfg.d_model, dtype, dev)
        else:
            shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
            per = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev)}
            if cfg.hybrid:
                per["ssm"] = ssm_init_state(batch, cfg.d_model,
                                            cfg.ssm_state, cfg.conv_kernel,
                                            dtype, dev)
        if cfg.cross_attn_every:
            n_groups, n_self = self._vlm_groups()
            shape = (n_groups, batch, cfg.n_img_tokens, cfg.n_kv_heads,
                     cfg.hd)
            return {"self": tree_map(lambda a: a.expand(
                        (n_groups, n_self, *a.shape)).contiguous(), per),
                    "cross": {n: torch.zeros(shape, dtype=dtype, device=dev)
                              for n in ("ck", "cv")}}
        return tree_map(lambda a: a.expand((cfg.n_layers, *a.shape))
                        .contiguous(), per)

    def prefill(self, params: Params, ids: torch.Tensor | None,
                cache: Params, *, embeds: torch.Tensor | None = None,
                img_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Params]:
        """Fill the cache with the prompt; returns (last-token hidden, cache).
        A vlm model also writes the image K/V of ``img_embeds`` into the
        cache's ``cross`` leaves, which its decode steps read.  ``ids``
        (``embeds``) split over a data axis: the rank's rows of the cache
        and of the hidden states."""
        h, cache = self._forward_cached(params, ids, cache, 0, embeds=embeds,
                                        img_embeds=img_embeds)
        return h[:, -1:], cache

    def decode_step(self, params: Params, ids_step: torch.Tensor | None,
                    cache: Params, pos: int, *,
                    embeds: torch.Tensor | None = None,
                    param_constraint=None) -> tuple[torch.Tensor, Params]:
        """One token for every sequence. pos: current cache length (an int
        or a 0-d tensor).  ``param_constraint``: applied to each layer's
        weights before the layer runs, after their ``data`` dim is
        gathered (a vlm model's too: the JAX package skips it there, where
        it changes no value)."""
        h, cache = self._forward_cached(params, ids_step, cache, pos,
                                        embeds=embeds,
                                        param_constraint=param_constraint)
        return self.logits(params, h), cache

    def _forward_cached(self, params: Params, ids, cache: Params, pos: int, *,
                        embeds=None, img_embeds=None, param_constraint=None
                        ) -> tuple[torch.Tensor, Params]:
        pcon = param_constraint or (lambda p: p)
        data = self._batch(ids, embeds)
        x = self._embed_in(params, ids, embeds, data)
        if self.cfg.cross_attn_every:
            return self._forward_cached_vlm(params, x, cache, int(pos),
                                            img_embeds, data, pcon)
        for lp, lc, (w, th) in zip(_unstack(params["layers"]),
                                   _unstack(cache), self._layer_meta()):
            x, new, _ = _block_apply(self.cfg, pcon(gather_data(lp, data)),
                                     x, window=w, theta=th, cache=lc,
                                     cache_pos=int(pos), data=data)
            _write_back(lc, new)
        x = rmsnorm(params["final_norm"], x)
        return x, cache

    def _forward_cached_vlm(self, params: Params, x: torch.Tensor,
                            cache: Params, pos: int, img_embeds, data=None,
                            pcon=lambda p: p) -> tuple[torch.Tensor, Params]:
        """The vlm prefill (``pos == 0``: the image K/V of ``img_embeds``
        written into ``cache["cross"]`` first) or decode step (the cached
        image K/V reused).  ``x``: this rank's rows of a batch split over
        ``data``, which the image embeddings and K/V hold too; each
        layer's weights gathered over ``data`` as it is read, then
        ``pcon``.  The self cache must hold every row of B for each self
        layer it holds (the JAX layout, its per-group dim split over
        ``data``; any other raises); its k/v are written and read through
        the data line (:func:`~repro_torch.models.layers.attention`)."""
        cfg = self.cfg
        n_groups, per = self._vlm_groups()
        for leaf in cache["self"].values():
            at = local_bounds(leaf)[2]
            if at.stop - at.start != leaf.shape[2]:
                raise ValueError(f"the vlm self cache holds rows {at} of its "
                                 f"batch of {leaf.shape[2]}: each self layer "
                                 f"it holds must hold every row (the JAX "
                                 f"layout)")
        cross = _unstack(params["cross"])
        img_kv = _unstack(cache["cross"])
        if pos == 0:
            img = self._img_in(img_embeds, x.shape[0], data)
            with _range(cfg, "vlm:cross_kv"):
                for cp, c in zip(cross, img_kv):
                    w = gather_data({n: cp["attn"][n] for n in ("wk", "wv")},
                                    data)
                    for wn, n in (("wk", "ck"), ("wv", "cv")):
                        _state_rows(c[n], x.shape[0], data, "image K/V cache")
                        kv = torch.einsum("bmd,dnh->bmnh", img, _local(w[wn]))
                        local_tensor(c[n]).copy_(_cache_part(kv, w[wn], c[n]))
        layers = _unstack(params["layers"], 2)
        caches = _unstack(cache["self"], 2)
        meta = self._layer_meta()
        for g in range(n_groups):
            for i in range(g * per, (g + 1) * per):
                w, th = meta[i]
                lp = pcon(gather_data(layers[i], data))
                x, new, _ = _block_apply(cfg, lp, x, window=w, theta=th,
                                         cache=caches[i], cache_pos=pos,
                                         data=data)
                _write_back(caches[i], new)
            x, _, _ = _block_apply(cfg, pcon(gather_data(cross[g], data)), x,
                                   window=0, theta=cfg.rope_theta,
                                   img_kv=img_kv[g], cache_pos=pos,
                                   is_cross=True, data=data)
        x = rmsnorm(params["final_norm"], x)
        return x, cache


# =========================================================================== #
# The layer stack as pipeline stages (core/spmd_pipeline.py)
# =========================================================================== #
def pipeline_layer(cfg: ArchConfig, i: int, seed: int, device=None) -> Params:
    """Layer ``i`` as a pipeline stage reads it: ``block``, its weights
    drawn by :func:`_block_init` from a generator of its own on ``device``
    (seeded ``seed + i``, so any rank draws the same layer alone), and its
    ``window`` and rope ``theta`` as 0-d leaves on the host (read without
    a device sync).  Self-attention layers of the families without cross
    layers."""
    dev = resolve_device(device)
    g = torch.Generator(dev).manual_seed(int(seed) + int(i))
    return {"block": _block_init(cfg, g),
            "window": torch.tensor(int(cfg.layer_windows[i])),
            "theta": torch.tensor(float(cfg.layer_thetas[i]),
                                  dtype=torch.float64)}


def pipeline_stage(cfg: ArchConfig, lo: int, hi: int, lmax: int, seed: int,
                   device=None) -> Params:
    """Layers ``lo..hi-1`` stacked [1, lmax, ...] (a rank's stage of
    :func:`~repro_torch.core.spmd_pipeline.spmd_pipeline_fn`), the padding
    zeros; drawn one layer at a time, so no more than the stack and one
    layer are alive."""
    first = pipeline_layer(cfg, lo, seed, device)
    stack = tree_map(lambda a: a.new_zeros((1, lmax, *a.shape)), first)
    for j, i in enumerate(range(lo, hi)):
        layer = first if j == 0 else pipeline_layer(cfg, i, seed, device)
        tree_map(lambda dst, src: dst[0, j].copy_(src), stack, layer)
    return stack


def pipeline_block(cfg: ArchConfig):
    """``block_fn(lp, h)`` of one :func:`pipeline_layer` (the JAX
    ``block_fn`` signature): the block's output; a moe block's aux losses
    are dropped."""
    def block(lp: Params, h: torch.Tensor) -> torch.Tensor:
        return _block_apply(cfg, lp["block"], h, window=int(lp["window"]),
                            theta=float(lp["theta"]))[0]
    return block


def params_from_numpy(tree: Any, dtype: str, device=None) -> Any:
    """The JAX package's ``LM.init`` parameters, as numpy arrays (or any
    array exposing ``__array__``), turned into the port's tree on
    ``device``: each leaf keeps the type of the JAX leaf it comes from
    (bfloat16, float16 or float32; the MoE router is f32 in a bf16 model),
    and a leaf of another type (float64 from numpy) takes the config's
    ``dtype``.  JAX's bf16 arrives as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, so each leaf goes through float32, which
    holds a bf16 value exactly."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dtype, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    kept = a.dtype.name in ("bfloat16", "float16", "float32")
    return torch.from_numpy(a.astype(np.float32)).to(
        device=dev, dtype=torch_dtype(a.dtype.name if kept else dtype))
