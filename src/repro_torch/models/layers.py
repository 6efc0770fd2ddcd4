"""Transformer building blocks — functional, param-dict style.

The port of the JAX package's ``models/layers.py`` for every family (the
rwkv block uses only :func:`rmsnorm` and :func:`_dense_init` from here).
Conventions, as there:

* params are nested dicts of tensors; layer stacks have leading dim L;
* compute dtype = config dtype (bf16 on the card); softmax and norms
  accumulate in f32;
* attention is GQA with an optional sliding window passed as data (a
  per-layer int), so gemma3's local/global stack is one loop.

Every self-attention over a whole prompt (the forward pass, and prefill
into an empty cache) and every cross-attention (``kv_x``: the vlm family's
image rows, unmasked, T != M) goes through
:func:`repro_torch.kernels.ops.attention`, the flash-attention kernel (K7)
on the card, whose backward is K8 and K9 under autograd (``expand_kv``'s
broadcast then sums each group's gradient back onto its kv head).  Decode
(new tokens at ``cache_pos > 0``) stays plain PyTorch, as the JAX package
computes it outside any Pallas kernel: K7's masks are aligned at position
0.

The sharding anchors (``_con_heads``, ``_con_ff``, and ``_con_groups``
and ``_con_experts`` for the MoE dispatch) sit where the JAX module puts
its ``with_sharding_constraint``s, under a layout registered with
:func:`set_attention_mesh` (which :func:`repro_torch.models.moe.moe_groups`
reads too).  A plain tensor is held whole by one process and passes
unchanged; a DTensor is redistributed to the divisibility-guarded spec.
Random init draws from a ``torch.Generator`` on the device the parameters
live on; given :data:`NO_DRAW` it draws nothing and returns the same tree
of shapes and types on the meta device.
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
class _NoDraw:
    """Stands in for a ``torch.Generator`` where nothing may be drawn (a
    meta device takes no generator): the inits return meta tensors."""

    device = torch.device("meta")


NO_DRAW = _NoDraw()


def _dense_init(generator: torch.Generator, shape: tuple, dtype: torch.dtype,
                scale: float | None = None) -> torch.Tensor:
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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

    The reshape-broadcast form of the JAX function (its lowering for a
    sharded cache; the other, a head-index take, gives the same values),
    contiguous, the layout K7 reads (``kv`` itself when G is 1 and it is
    contiguous already, else a new tensor).  Its gradient sums each
    group's G heads onto their kv head in one reduction (f32 sums, rounded
    once), the same on every run; a take's gradient adds them in with
    float atomics on the card, in any order, each add rounded to the
    gradient's type.
    """
    B, M, KV, hd = kv.shape
    G = n_heads // KV
    return kv[:, :, :, None].expand(B, M, KV, G, hd).contiguous().view(
        B, M, n_heads, hd)


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


# --------------------------------------------------------------------------- #
# Sharding anchors (the JAX module's with_sharding_constraint sites)
# --------------------------------------------------------------------------- #
_ATTN_MESH = None


def set_attention_mesh(mesh) -> None:
    """Register the mesh layout (anything with ``axis_names`` and
    ``shape[axis]``) that the anchors and ``moe_groups`` read; None clears
    it.  Set by the step builders of :mod:`repro_torch.launch.steps`."""
    global _ATTN_MESH
    _ATTN_MESH = mesh


def attention_mesh():
    """The registered layout, or None."""
    return _ATTN_MESH


def _batch_ax(mesh, n: int):
    """The batch axes (pod, data) for a leading dim of ``n``, if they
    divide it (one name alone when there is one axis)."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    nb = math.prod(mesh.shape[a] for a in baxes)
    b_ax = baxes if baxes and n % nb == 0 else None
    return b_ax[0] if isinstance(b_ax, tuple) and len(b_ax) == 1 else b_ax


def heads_spec(mesh, shape: tuple) -> tuple:
    """[B, T, H, hd] → batch × head sharding; head_dim over ``model`` when
    the heads do not divide it."""
    B, T, H, hd = shape
    model = "model" in mesh.axis_names
    h_ax = "model" if model and H % mesh.shape["model"] == 0 else None
    d_ax = ("model" if h_ax is None and model
            and hd % mesh.shape["model"] == 0 else None)
    return (_batch_ax(mesh, B), None, h_ax, d_ax)


def groups_spec(mesh, shape: tuple) -> tuple | None:
    """[G, Ng, d] routing groups → G over the batch axes (None: leave)."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not baxes or shape[0] % math.prod(mesh.shape[a] for a in baxes):
        return None
    return (baxes if len(baxes) > 1 else baxes[0], None, None)


def experts_spec(mesh, shape: tuple) -> tuple | None:
    """[G, E, C, ...] expert buffers → E over ``model`` (None: leave)."""
    if "model" not in mesh.axis_names or shape[1] % mesh.shape["model"]:
        return None
    return (_batch_ax(mesh, shape[0]), "model") + (None,) * (len(shape) - 2)


def ff_spec(mesh, shape: tuple) -> tuple | None:
    """[B, T, ..., ff] → ff over ``model`` (None: leave)."""
    if "model" not in mesh.axis_names or shape[-1] % mesh.shape["model"]:
        return None
    return (_batch_ax(mesh, shape[0]),) + (None,) * (len(shape) - 2) + (
        "model",)


def _anchor(x: torch.Tensor, spec_of) -> torch.Tensor:
    if _ATTN_MESH is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x                      # one process holds it whole
    spec = spec_of(_ATTN_MESH, tuple(x.shape))
    if spec is None:
        return x
    from ..launch.sharding import with_spec
    return with_spec(x, spec)


def _con_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, hd] anchored to :func:`heads_spec`."""
    return _anchor(x, heads_spec)


def _con_groups(x: torch.Tensor) -> torch.Tensor:
    """[G, Ng, d] anchored to :func:`groups_spec` (the MoE dispatch)."""
    return _anchor(x, groups_spec)


def _con_experts(x: torch.Tensor) -> torch.Tensor:
    """[G, E, C, ...] anchored to :func:`experts_spec` (EP compute)."""
    return _anchor(x, experts_spec)


def _con_ff(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ..., ff] anchored to :func:`ff_spec` (the MLP hidden)."""
    return _anchor(x, ff_spec)


def attention(p: Params, x: torch.Tensor, pos=None, *, theta, window: int = 0,
              kv_x: torch.Tensor | None = None, cache: Params | None = None,
              cache_pos: int | None = None
              ) -> tuple[torch.Tensor, Params | None]:
    """Self-attention, causal (+ window), or cross-attention.

    * forward (cache=None): the whole sequence through K7;
    * prefill (cache given, ``cache_pos == 0``): k/v written into the cache
      (in place), then K7 over the first T cache rows — the rows beyond T
      are causally masked in the JAX function, so the result is the same;
    * decode (``cache_pos > 0``): plain masked softmax over the cache;
    * cross-attention (``kv_x`` [B, M, d] and no cache): q from ``x``, k
      and v from ``kv_x``, no rope and no mask, through K7 with
      ``causal=False`` (the JAX function's plain softmax below T = 2048
      and its chunked one from there are the same function).
    """
    del pos                                     # positions come from T
    window = int(window)
    B, T, _ = x.shape
    q = torch.einsum("btd,dnh->btnh", x, p["wq"])
    src = x if kv_x is None else kv_x
    k = torch.einsum("bmd,dnh->bmnh", src, p["wk"])
    v = torch.einsum("bmd,dnh->bmnh", src, p["wv"])
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
            out = ops.attention(_con_heads(q),
                                _con_heads(expand_kv(ck[:, :T], H)),
                                _con_heads(expand_kv(cv[:, :T], H)), True,
                                window).reshape(B, T, H * hd)
        else:                                   # decode
            k_pos = torch.arange(ck.shape[1], device=x.device)
            mask = attn_mask(q_pos, k_pos, window)
            scores = gqa_scores(_con_heads(q), _con_heads(expand_kv(ck, H)))
            scores = torch.where(mask[None, None], scores,
                                 torch.full((), NEG_INF, device=x.device))
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = gqa_combine(probs, _con_heads(expand_kv(cv, H)))
    elif kv_x is not None:                      # cross-attention: K7
        out = ops.attention(_con_heads(q), _con_heads(expand_kv(k, H)),
                            _con_heads(expand_kv(v, H)), False,
                            0).reshape(B, T, H * hd)
    else:                                       # forward: K7
        q_pos = torch.arange(T, device=x.device)
        q = apply_rope(q, q_pos[None, :], theta)
        k = apply_rope(k, q_pos[None, :], theta)
        out = ops.attention(_con_heads(q), _con_heads(expand_kv(k, H)),
                            _con_heads(expand_kv(v, H)), True,
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
    gu = _con_ff(torch.einsum("btd,dcf->btcf", x, p["wi"]))
    g, u = gu[:, :, 0], gu[:, :, 1]
    h = _con_ff(F.silu(g) * u)
    return torch.einsum("btf,fd->btd", h, p["wo"])


# --------------------------------------------------------------------------- #
# Embedding / LM head
# --------------------------------------------------------------------------- #
def embed_init(generator: torch.Generator, vocab_padded: int, d: int,
               dtype: torch.dtype) -> Params:
    return {"table": _dense_init(generator, (vocab_padded, d), dtype,
                                 scale=1.0)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``ids`` (the JAX ``jnp.take``).  ``F.embedding``
    sums a row's gradient without atomics, the same on every run; a
    subscript's gradient (``index_put_`` with accumulate) adds with float
    atomics on the card."""
    return F.embedding(ids, p["table"])


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
