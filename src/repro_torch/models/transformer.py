"""Decoder-only LM — the port of the JAX package's ``models/transformer.py``
for the dense family.

Families ported: ``dense`` (GQA attention + SwiGLU: deepseek-67b, gemma3-12b,
gemma3-27b, mistral-large-123b) and ``audio`` (musicgen-large: the same
dense backbone over precomputed frame embeddings, ``embeds_in``).  The moe,
hybrid, ssm (rwkv) and vlm families raise ``NotImplementedError``.

The JAX ``lax.scan`` over the stacked ``[L, ...]`` parameters is a Python
loop over the same stacked tensors; per-layer heterogeneity (gemma3's
sliding window and rope theta) rides along as per-layer data, so the
parameter tree has the JAX tree's layout and :func:`params_from_numpy`
carries JAX weights across unchanged.  The KV cache is updated in place.

Training: ``apply(remat=True)`` checkpoints every layer with
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint`` body), and with
``scan_chunks=c`` every chunk of c layers as well; :meth:`LM.loss` is the
chunked cross-entropy, one checkpointed chunk of ``[B, chunk, V]`` f32
logits alive at a time.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.placement import resolve_device
from ..core.tree import flatten, tree_map, unflatten
from .config import ArchConfig
from .layers import (attention, attention_init, embed, embed_init, lm_logits,
                     logits_f32, mlp, mlp_init, rmsnorm, rmsnorm_init)

Params = Any


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16``."""
    return getattr(torch, name)


def unported_family(cfg: ArchConfig) -> str | None:
    """Why the port cannot run ``cfg`` yet (None when it can)."""
    if cfg.rwkv:
        return "the rwkv (ssm) family"
    if cfg.hybrid or cfg.ssm_state:
        return "the hybrid (ssm) family"
    if cfg.n_experts:
        return "the moe family"
    if cfg.cross_attn_every:
        return "the vlm family (cross-attention)"
    return None


# =========================================================================== #
# Per-layer block
# =========================================================================== #
def _block_init(cfg: ArchConfig, generator: torch.Generator) -> Params:
    dtype = torch_dtype(cfg.dtype)
    dev = generator.device
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
            "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": attention_init(generator, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd, dtype),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype)}


def _block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                 window: int, theta: float, cache: Params | None = None,
                 cache_pos: int | None = None
                 ) -> tuple[torch.Tensor, Params | None]:
    """One dense block (``LM`` refuses the other families). Returns
    (x, new_cache)."""
    del cfg
    h = rmsnorm(p["ln1"], x)
    a, new_cache = attention(p["attn"], h, None, theta=theta, window=window,
                             cache=cache, cache_pos=cache_pos)
    x = x + a
    h2 = rmsnorm(p["ln2"], x)
    x = x + mlp(p["mlp"], h2)
    return x, new_cache


def _unstack(tree: Params) -> list[Params]:
    """The layers of a stacked ``[L, ...]`` tree (views, no copies): one
    ``unbind`` per leaf, so autograd stacks the layers' gradients once."""
    flat, treedef = flatten(tree)
    cols = [a.unbind(0) for a in flat]
    return [unflatten(treedef, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    JAX ``jax.checkpoint``); a plain call where no gradient is recorded."""
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


# =========================================================================== #
# The model
# =========================================================================== #
class LM:
    def __init__(self, cfg: ArchConfig):
        reason = unported_family(cfg)
        if reason:
            raise NotImplementedError(
                f"{cfg.arch_id}: {reason} is not ported yet (ROADMAP item 9)")
        self.cfg = cfg

    # -- params -------------------------------------------------------------- #
    def init(self, generator: torch.Generator) -> Params:
        """Random weights on the generator's device, in the config's dtype."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        params: dict = {
            "embed": embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device),
        }
        layers = [_block_init(cfg, generator) for _ in range(cfg.n_layers)]
        params["layers"] = tree_map(lambda *a: torch.stack(a), *layers)
        return params

    def _layer_meta(self) -> list[tuple[int, float]]:
        cfg = self.cfg
        return [(int(w), float(t))
                for w, t in zip(cfg.layer_windows, cfg.layer_thetas)]

    def _embed_in(self, params: Params, ids, embeds) -> torch.Tensor:
        x = embeds if self.cfg.embeds_in else embed(params["embed"], ids)
        return x.to(torch_dtype(self.cfg.dtype))

    # -- full-sequence forward ------------------------------------------------ #
    def apply(self, params: Params, ids: torch.Tensor | None = None, *,
              embeds: torch.Tensor | None = None, remat: bool = True,
              scan_chunks: int = 0) -> torch.Tensor:
        """→ hidden [B, S, d]. Use :meth:`loss` / :meth:`logits` after.  (The
        JAX ``apply`` also returns the MoE aux losses; the dense family has
        none.)

        ``remat``: recompute each layer's activations in the backward pass.
        ``scan_chunks=c``: also checkpoint each chunk of c layers (the JAX
        nested-remat scan), ignored unless c divides ``n_layers``."""
        cfg = self.cfg
        x = self._embed_in(params, ids, embeds)
        layers = _unstack(params["layers"])
        meta = self._layer_meta()

        def layer(i: int, h: torch.Tensor) -> torch.Tensor:
            w, th = meta[i]
            return _block_apply(cfg, layers[i], h, window=w, theta=th)[0]

        def run(lo: int, hi: int, h: torch.Tensor) -> torch.Tensor:
            for i in range(lo, hi):
                h = _remat(layer, i, h) if remat else layer(i, h)
            return h

        c = scan_chunks
        if remat and c and cfg.n_layers % c == 0:
            for lo in range(0, cfg.n_layers, c):
                x = _remat(run, lo, lo + c, x)
        else:
            x = run(0, cfg.n_layers, x)
        return rmsnorm(params["final_norm"], x)

    def loss(self, params: Params, hidden: torch.Tensor,
             targets: torch.Tensor, mask: torch.Tensor | None = None,
             chunk: int = 512) -> torch.Tensor:
        """Mean next-token cross-entropy over the masked tokens, f32.

        As the JAX ``LM.loss``: ``S // chunk`` chunks (the tail tokens are
        dropped), logits of the embedding table (bf16 products summed in
        f32, f32 out; :func:`~repro_torch.models.layers.logits_f32`) sliced
        to the vocab; each chunk checkpointed, so one chunk's logits are
        alive at a time."""
        B, S, _ = hidden.shape
        chunk = min(chunk, S)
        table = params["embed"]["table"]
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for lo in range(0, S // chunk * chunk, chunk):
            sl = slice(lo, lo + chunk)
            t = targets[:, sl]
            m = (mask[:, sl].to(torch.float32) if mask is not None else
                 torch.ones(t.shape, dtype=torch.float32, device=t.device))
            tot = tot + _remat(_chunk_nll, hidden[:, sl], table, t, m,
                               self.cfg.vocab)
            cnt = cnt + m.sum()
        return tot / torch.clamp(cnt, min=1.0)

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(params["embed"], hidden, self.cfg.vocab)

    # -- KV cache / serving ----------------------------------------------------- #
    def init_cache(self, batch: int, cache_len: int, device=None) -> Params:
        """Zero k/v caches ``[L, B, cache_len, KV, hd]`` on ``device`` (the
        card unless ``device="cpu"``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        dtype = torch_dtype(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def prefill(self, params: Params, ids: torch.Tensor | None,
                cache: Params, *, embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Params]:
        """Fill the cache with the prompt; returns (last-token hidden, cache)."""
        h, cache = self._forward_cached(params, ids, cache, 0, embeds=embeds)
        return h[:, -1:], cache

    def decode_step(self, params: Params, ids_step: torch.Tensor | None,
                    cache: Params, pos: int, *,
                    embeds: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, Params]:
        """One token for every sequence. pos: current cache length."""
        h, cache = self._forward_cached(params, ids_step, cache, pos,
                                        embeds=embeds)
        return self.logits(params, h), cache

    def _forward_cached(self, params: Params, ids, cache: Params, pos: int, *,
                        embeds=None) -> tuple[torch.Tensor, Params]:
        x = self._embed_in(params, ids, embeds)
        for lp, lc, (w, th) in zip(_unstack(params["layers"]),
                                   _unstack(cache), self._layer_meta()):
            x, _ = _block_apply(self.cfg, lp, x, window=w, theta=th,
                                cache=lc, cache_pos=int(pos))
        x = rmsnorm(params["final_norm"], x)
        return x, cache


def params_from_numpy(tree: Any, dtype: str, device=None) -> Any:
    """The JAX package's ``LM.init`` parameters, as numpy arrays (or any
    array exposing ``__array__``), turned into the port's tree: every array
    leaf becomes a tensor of the config's ``dtype`` (``"bfloat16"``) on
    ``device``.  JAX's bf16 arrives as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so each leaf
    goes through float32, which holds a bf16 value exactly."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dtype, dev) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).astype(np.float32)).to(
        device=dev, dtype=torch_dtype(dtype))
