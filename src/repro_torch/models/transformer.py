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
carries JAX weights across unchanged.  The forward pass has no remat and
no ``scan_chunks`` (training waits for its slice).  The KV cache is
updated in place.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.placement import resolve_device
from .config import ArchConfig
from .layers import (attention, attention_init, embed, embed_init, lm_logits,
                     mlp, mlp_init, rmsnorm, rmsnorm_init)

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


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked ``[L, ...]`` tree (views, no copies)."""
    return _tree_map(lambda a: a[i], tree)


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
        params["layers"] = _tree_map(lambda *a: torch.stack(a), *layers)
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
              embeds: torch.Tensor | None = None
              ) -> torch.Tensor:
        """→ hidden [B, S, d]. Use :meth:`logits` after.  (The JAX ``apply``
        also returns the MoE aux losses; the dense family has none.)"""
        x = self._embed_in(params, ids, embeds)
        for i, (w, th) in enumerate(self._layer_meta()):
            x, _ = _block_apply(self.cfg, _layer(params["layers"], i), x,
                                window=w, theta=th)
        x = rmsnorm(params["final_norm"], x)
        return x

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
        for i, (w, th) in enumerate(self._layer_meta()):
            x, _ = _block_apply(self.cfg, _layer(params["layers"], i), x,
                                window=w, theta=th,
                                cache=_layer(cache, i), cache_pos=int(pos))
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
