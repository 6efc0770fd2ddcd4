"""Transformer building blocks — functional, param-dict style.

The port of the JAX package's ``models/layers.py`` for the dense and moe
families.  Conventions, as there:

* params are nested dicts of tensors; layer stacks have leading dim L;
* compute dtype = config dtype (bf16 on the card); softmax and norms
  accumulate in f32;
* attention is GQA with an optional sliding window passed as data (a
  per-layer int), so gemma3's local/global stack is one loop.

Every self-attention over a whole prompt (the forward pass, and prefill
into an empty cache) goes through :func:`repro_torch.kernels.ops.attention`,
the flash-attention kernel (K7) on the card, whose backward is K8 and K9
under autograd (``expand_kv``'s gather then sums each group's gradient
back onto its kv head).  Decode (new tokens at
``cache_pos > 0``) stays plain PyTorch, as the JAX package computes it
outside any Pallas kernel: K7's masks are aligned at position 0.

The JAX module's sharding anchors (``_con_*``, ``set_attention_mesh``;
``_con_experts`` and ``_con_groups`` anchor the MoE dispatch) wait for the
sharding slice; without a mesh they are the identity, so they are left
out.  Random init draws from a ``torch.Generator`` on the device the
parameters live on.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops

Params = Any
NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #
def _dense_init(generator: torch.Generator, shape: tuple, dtype: torch.dtype,
                scale: float | None = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


# --------------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------------- #
def rmsnorm_init(d: int, dtype: torch.dtype, device=None) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE (theta passed as data → a per-layer theta)
# --------------------------------------------------------------------------- #
def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta) -> torch.Tensor:
    """x: [..., T, n, hd]; pos: [..., T] absolute positions."""
    hd = x.shape[-1]
    half = hd // 2
    theta = torch.as_tensor(theta, dtype=torch.float32, device=x.device)
    freq = torch.exp(-torch.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].to(torch.float32) * freq          # [..., T, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# GQA attention (full / sliding-window), optional KV cache
# --------------------------------------------------------------------------- #
def attention_init(generator: torch.Generator, d: int, n_heads: int,
                   n_kv: int, hd: int, dtype: torch.dtype) -> Params:
    return {
        "wq": _dense_init(generator, (d, n_heads, hd), dtype),
        "wk": _dense_init(generator, (d, n_kv, hd), dtype),
        "wv": _dense_init(generator, (d, n_kv, hd), dtype),
        "wo": _dense_init(generator, (n_heads * hd, d), dtype),
    }


def expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, M, KV, hd] → [B, M, H, hd]; q-head h uses kv-head h // (H/KV).

    The gather form of the JAX function (a head-index take), which leaves a
    new contiguous tensor, the layout K7 reads.
    """
    G = n_heads // kv.shape[2]
    idx = torch.arange(n_heads, device=kv.device) // G
    return torch.index_select(kv, 2, idx)


def gqa_scores(q: torch.Tensor, k_exp: torch.Tensor) -> torch.Tensor:
    """q: [B, T, H, hd], k_exp: [B, M, H, hd] → scores [B, H, T, M] f32."""
    hd = q.shape[-1]
    return torch.einsum("bthd,bmhd->bhtm", q.to(torch.float32),
                        k_exp.to(torch.float32)) / math.sqrt(hd)


def gqa_combine(probs: torch.Tensor, v_exp: torch.Tensor) -> torch.Tensor:
    """probs: [B, H, T, M], v_exp: [B, M, H, hd] → [B, T, H*hd]."""
    B, H, T, M = probs.shape
    hd = v_exp.shape[-1]
    out = torch.einsum("bhtm,bmhd->bthd", probs, v_exp)
    return out.reshape(B, T, H * hd)


def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
              causal: bool = True) -> torch.Tensor:
    """[T, M] bool. window: 0/negative → unbounded."""
    d = q_pos[:, None] - k_pos[None, :]
    m = (d >= 0) if causal else torch.ones(d.shape, dtype=torch.bool,
                                           device=d.device)
    if window > 0:
        m = m & (d < window)
    return m


def attention(p: Params, x: torch.Tensor, pos=None, *, theta, window: int = 0,
              kv_x: torch.Tensor | None = None, cache: Params | None = None,
              cache_pos: int | None = None
              ) -> tuple[torch.Tensor, Params | None]:
    """Self-attention, causal (+ window).

    * forward (cache=None): the whole sequence through K7;
    * prefill (cache given, ``cache_pos == 0``): k/v written into the cache
      (in place), then K7 over the first T cache rows — the rows beyond T
      are causally masked in the JAX function, so the result is the same;
    * decode (``cache_pos > 0``): plain masked softmax over the cache.

    Cross-attention (``kv_x``, the vlm family) is not ported yet.
    """
    del pos                                     # positions come from T
    if kv_x is not None:
        raise NotImplementedError(
            "cross-attention (the vlm family) waits for the vlm item of "
            "ROADMAP.md queue 1")
    window = int(window)
    B, T, _ = x.shape
    q = torch.einsum("btd,dnh->btnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", x, p["wk"])
    v = torch.einsum("btd,dnh->btnh", x, p["wv"])
    H, hd = q.shape[2], q.shape[3]

    new_cache = None
    if cache is not None:
        start = int(cache_pos)
        q_pos = start + torch.arange(T, device=x.device)
        q = apply_rope(q, q_pos[None, :], theta)
        k = apply_rope(k, q_pos[None, :], theta)
        ck, cv = cache["k"], cache["v"]
        ck[:, start:start + T] = k.to(ck.dtype)
        cv[:, start:start + T] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        if start == 0:                          # prefill: K7
            out = ops.attention(q, expand_kv(ck[:, :T], H),
                                expand_kv(cv[:, :T], H), True,
                                window).reshape(B, T, H * hd)
        else:                                   # decode
            k_pos = torch.arange(ck.shape[1], device=x.device)
            mask = attn_mask(q_pos, k_pos, window)
            scores = gqa_scores(q, expand_kv(ck, H))
            scores = torch.where(mask[None, None], scores,
                                 torch.full((), NEG_INF, device=x.device))
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = gqa_combine(probs, expand_kv(cv, H))
    else:                                       # forward: K7
        q_pos = torch.arange(T, device=x.device)
        q = apply_rope(q, q_pos[None, :], theta)
        k = apply_rope(k, q_pos[None, :], theta)
        out = ops.attention(q, expand_kv(k, H), expand_kv(v, H), True,
                            window).reshape(B, T, H * hd)

    y = torch.einsum("btf,fd->btd", out, p["wo"])
    return y, new_cache


# --------------------------------------------------------------------------- #
# SwiGLU MLP
# --------------------------------------------------------------------------- #
def mlp_init(generator: torch.Generator, d: int, ff: int,
             dtype: torch.dtype) -> Params:
    return {"wi": _dense_init(generator, (d, 2, ff), dtype),
            "wo": _dense_init(generator, (ff, d), dtype)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    gu = torch.einsum("btd,dcf->btcf", x, p["wi"])
    g, u = gu[:, :, 0], gu[:, :, 1]
    h = F.silu(g) * u
    return torch.einsum("btf,fd->btd", h, p["wo"])


# --------------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------------- #
def embed_init(generator: torch.Generator, vocab_padded: int, d: int,
               dtype: torch.dtype) -> Params:
    return {"table": _dense_init(generator, (vocab_padded, d), dtype,
                                 scale=1.0)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32, f32 out: bf16 operands on the card go through
    ``torch.mm(out_dtype=float32)`` (no f32 copy of either); elsewhere both
    are cast to f32, which holds their products exactly."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def bf16_terms(x: torch.Tensor) -> torch.Tensor:
    """f32 x -> [3, *x.shape] bf16 whose f32 sum is x exactly: each term
    takes the next 8 significant bits of what the ones before left over."""
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    rest = x
    for i in range(3):
        out[i] = rest
        rest = rest - out[i].to(torch.float32)
    return out


class _LogitsF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(h, table)
        return _mm_f32(h, table.t())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, table = ctx.saved_tensors
        if not (g.is_cuda and h.dtype == table.dtype == torch.bfloat16):
            return (_mm_f32(g, table).to(h.dtype),
                    _mm_f32(g.t(), h).to(table.dtype))
        n = g.shape[0]
        terms = bf16_terms(g).reshape(3 * n, -1)
        dh = torch.mm(terms, table, out_dtype=torch.float32)
        dt = torch.mm(terms.t(), h.repeat(3, 1), out_dtype=torch.float32)
        return dh.reshape(3, n, -1).sum(0).to(h.dtype), dt.to(table.dtype)


def logits_f32(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """h [N, d] @ table [V, d]ᵀ → [N, V] f32: the training loss's logits,
    the JAX einsum's arithmetic (products of the input type summed in f32,
    ``preferred_element_type=float32``) without an f32 copy of the table.
    The backward keeps the f32 gradient g as it is, as JAX's transpose rule
    does (``lax._dot_general_transpose_lhs``/``_rhs`` multiply the f32
    cotangent by the other operand with ``preferred_element_type`` f32): on
    the card g goes in as the three bf16 terms of :func:`bf16_terms`, so
    each product is bf16 x bf16 summed in f32 and equals the f32 product
    up to the order of sums.  f32 sums come out in the inputs' types."""
    return _LogitsF32.apply(h, table)


def lm_logits(p: Params, h: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, T, d] → [B, T, vocab] f32 (products of the input type, summed in
    f32, as the JAX einsum's ``preferred_element_type``), without an f32
    copy of the table."""
    B, T, d = h.shape
    return _mm_f32(h.reshape(B * T, d),
                   p["table"][:vocab].t()).reshape(B, T, vocab)
