"""Architecture configs — the selectable ``--arch`` model space.

A copy of the JAX package's ``models/config.py`` (pure Python and numpy),
kept here so that the port imports nothing of that package.  One frozen
dataclass describes every assigned architecture; per-layer heterogeneity
(gemma3's 5:1 local:global attention, llama-vision's cross-attn layers) is
encoded as data, read by the layer loop of
:class:`repro_torch.models.transformer.LM`.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads

    # attention pattern
    window: int = 0                # 0 → full attention; else sliding window
    global_every: int = 0          # gemma3: every k-th layer is global
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0  # 0 → same as rope_theta

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    hybrid: bool = False           # hymba: parallel attn + ssm heads
    rwkv: bool = False             # rwkv6: attention-free token mixing
    conv_kernel: int = 4

    # VLM (cross-attn image layers, stub frontend per task spec)
    cross_attn_every: int = 0      # every k-th layer is a cross-attn layer
    n_img_tokens: int = 1024

    # audio (decoder over precomputed EnCodec frame embeddings, stub frontend)
    embeds_in: bool = False        # model input is embeddings, not token ids

    dtype: str = "bfloat16"
    vocab_pad_to: int = 256
    tie_embeddings: bool = True

    # -- derived ------------------------------------------------------------- #
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, self.vocab_pad_to)

    @property
    def is_global_layer(self) -> np.ndarray:
        """Per-layer bool: full ("global") attention vs sliding window."""
        if self.global_every <= 0:
            return np.ones(self.n_layers, bool) if self.window == 0 \
                else np.zeros(self.n_layers, bool)
        idx = np.arange(self.n_layers)
        return (idx % self.global_every) == (self.global_every - 1)

    @property
    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window (0 = unbounded), scannable as data."""
        w = np.full(self.n_layers, self.window or 0, dtype=np.int32)
        w[self.is_global_layer] = 0
        return w

    @property
    def layer_thetas(self) -> np.ndarray:
        th = np.full(self.n_layers, self.rope_theta, dtype=np.float32)
        if self.rope_theta_global:
            th[self.is_global_layer] = self.rope_theta_global
        return th

    @property
    def is_cross_layer(self) -> np.ndarray:
        if self.cross_attn_every <= 0:
            return np.zeros(self.n_layers, bool)
        idx = np.arange(self.n_layers)
        return (idx % self.cross_attn_every) == (self.cross_attn_every - 1)

    @property
    def n_params(self) -> float:
        """Total parameter count (for MODEL_FLOPS = 6·N·D)."""
        return _count_params(self, active_only=False)

    @property
    def n_params_active(self) -> float:
        """Active parameters per token (MoE: top_k experts only)."""
        return _count_params(self, active_only=True)

    def reduced(self, **overrides: Any) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=128, vocab=256, head_dim=16,
            n_img_tokens=16, dtype="float32",
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=2)
        if self.window:
            small.update(window=8)
        if self.ssm_state:
            small.update(ssm_state=4)
        if self.cross_attn_every:
            small.update(cross_attn_every=2, n_layers=4)   # 2×(1 self + 1 cross)
        small.update(overrides)
        return replace(self, **small)


def _count_params(c: ArchConfig, active_only: bool) -> float:
    d, hd = c.d_model, c.hd
    emb = c.vocab_padded * d
    head = 0 if c.tie_embeddings else c.vocab_padded * d
    per_layer = 2 * d                                   # 2 rms norms
    if c.rwkv:
        per_layer += 6 * d * d                          # r,k,v,w,g,out projections
        per_layer += 2 * d                              # token-shift mixes (approx)
        per_layer += d * c.d_ff + c.d_ff * d + d * d    # channel mix (k,v,r)
    else:
        per_layer += d * c.n_heads * hd + 2 * d * c.n_kv_heads * hd \
            + c.n_heads * hd * d                        # q,k,v,o
        if c.hybrid:                                    # hymba ssm branch
            di = d
            per_layer += d * 2 * di + di * c.conv_kernel \
                + di * (2 * c.ssm_state + 2) + di * c.ssm_state + di * d
        if c.cross_attn_every:
            n_cross = int(c.is_cross_layer.sum())
            # cross-attn kv projections amortized over all layers
            per_layer += (2 * d * c.n_kv_heads * hd + d * c.n_heads * hd
                          + c.n_heads * hd * d) * n_cross / c.n_layers
        if c.n_experts:
            e = c.top_k if active_only else c.n_experts
            per_layer += e * (2 * d * c.d_ff + c.d_ff * d)   # swiglu experts
            per_layer += d * c.n_experts                      # router
        else:
            per_layer += 2 * d * c.d_ff + c.d_ff * d          # swiglu
    return emb + head + c.n_layers * per_layer + d               # final norm


# --------------------------------------------------------------------------- #
# Input shapes (assigned per task spec; same 4 for every LM arch)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def needs_subquadratic(shape: ShapeConfig) -> bool:
    return shape.name == "long_500k"


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k only runs for sub-quadratic archs (see DESIGN.md §5)."""
    if not needs_subquadratic(shape):
        return True, ""
    if cfg.rwkv or cfg.ssm_state or cfg.window:
        return True, ""
    return False, ("pure full-attention arch: 524k decode requires a full "
                   "KV cache the shape list excludes by construction "
                   "(DESIGN.md §5)")
