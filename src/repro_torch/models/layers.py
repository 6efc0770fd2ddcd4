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

The sharding anchors (``_con_heads``, ``_con_ff``) sit where the JAX
module puts its ``with_sharding_constraint``s, under a layout registered with
:func:`set_attention_mesh` (which :func:`repro_torch.models.moe.moe_groups`
reads too).  A plain tensor is held whole by one process and passes
unchanged; a DTensor is redistributed to the divisibility-guarded spec.
Random init draws from a ``torch.Generator`` on the device the parameters
live on; given :data:`NO_DRAW` it draws nothing and returns the same tree
of shapes and types on the meta device.

Tensor parallelism across ranks: weights that are DTensors, laid out by
:func:`repro_torch.launch.sharding.param_shardings_serving` or
``param_shardings`` (and a cache by ``cache_shardings``), make
:func:`attention`, :func:`mlp`, :func:`embed` and :func:`lm_logits` run on
each rank's shard (Megatron's split, which the JAX anchors make GSPMD
choose): q, k and v of the rank's heads from its columns of
``wq``/``wk``/``wv``, K7 on those local heads, their product with the
rank's rows of ``attn/wo``; the MLP hidden on the rank's ff columns and
its rows of ``mlp/wo``; the embedding from the rank's vocab rows; the
logits of its vocab rows, gathered.  Each row split's partial product is
kept in f32 and summed over the model axis once
(:func:`repro_torch.core.spmd_pipeline.all_reduce_sum`, through pinned
host memory when the ranks share a card), so the activations between
layers stay whole on every rank and plain tensors.  A dim the guard left
whole (``n_kv_heads`` not dividing the axis: k and v computed whole, the
cache's head_dim sharded and gathered to decode) is cut to what the
rank's heads read.  The vlm family's self and image K/V caches keep every
kv head at the rank's part of head_dim while ``wk``/``wv`` split the kv
heads: each write gathers the ranks' kv heads first (:func:`_cache_part`),
each read gathers head_dim (:func:`_cache_read`).  Cross-attention
(``kv_x``) runs on the rank's heads against the image rows of its batch
rows, which every model rank holds whole.  One body serves every case: a
plain weight is a whole shard, and the one-process path computes what it
always did.

Training under autograd takes the collectives' conjugates: the input of a
column split passes through
:func:`~repro_torch.core.spmd_pipeline.copy_to_ranks` (its gradient, a
part on each rank, summed); with the sequence-parallel carry
(:class:`SeqParallel`) the norms and residual adds run on each rank's part
of the tokens, a column split's input is gathered along S
(:func:`~repro_torch.core.spmd_pipeline.gather_seq`) and a row split's sum
comes back as the rank's part
(:func:`~repro_torch.core.spmd_pipeline.reduce_scatter`).  A leaf every
rank holds whole has its gradient summed exactly when the ranks split its
use (:func:`_local`, the one place of that rule).  The moe family's
experts are split over the same axis (expert parallelism,
:mod:`repro_torch.models.moe`): each rank runs its E/m experts on its
local weights and the combine is a row split's sum; the hybrid and ssm
families' recurrences run on each rank's channels or heads by the same
helpers (:mod:`repro_torch.models.ssm`, :mod:`repro_torch.models.rwkv`).
The anchors therefore see local, plain activations here, and pass them
unchanged.

A data axis over more than one rank (FSDP): weights by ``param_shardings``
keep a storage-only dim split over ``data``; :func:`gather_data` gathers a
layer's weights (and the embedding table) over it just before they are
read, so every layer above sees the model-axis layout alone, and its
gradient is summed back over ``data`` (each rank's part of the batch gives
a part of it).  The activations, the cache and the batch stay each rank's
rows, but for the vlm self cache, whose JAX layout splits each group's
self layers over ``data`` and keeps every row of B: its layers come
unstacked as :class:`~repro_torch.core.spmd_pipeline.HeldBy` records,
each layer held by one data rank (or, where ``data`` does not divide the
group's layers, whole on every rank).  Each write gathers the ranks' rows
over ``data`` in rank order (exact) and the holder writes them
(:func:`_cache_write`); each decode read takes the rank's rows, sent by
the owner in a point-to-point exchange every data rank joins
(:func:`_cache_read`, :func:`~repro_torch.core.spmd_pipeline.held_rows`).
A cache whose rows are neither the batch's nor all of them raises
(:func:`_cache_rows`).  A ``pod`` axis beside ``data`` (a ``(pod, data,
model)`` mesh) is a second batch axis: the batch's line, the ``data``
argument of these functions, is then the ``(pod, data)`` group (its ranks
pod-major, :func:`~repro_torch.core.spmd_pipeline.batch_line`), which the
states, the caches' rows, the vlm self cache's gathers and exchanges and
the sums read; weights are never split over ``pod`` and
:func:`gather_data` stays over ``data``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.spmd_pipeline import (HeldBy, all_gather_cat, all_reduce_sum,
                                   batch_line, copy_to_ranks, gather_seq,
                                   group_transport, held_rows, is_dtensor,
                                   local_bounds, own_part, reduce_scatter,
                                   unshard, with_spec)
from ..core.tree import tree_map
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


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6, *,
            split: bool = False) -> torch.Tensor:
    """``split``: ``x`` is this rank's part of the tokens (the
    sequence-parallel carry), so the scale's use is split (:func:`_local`)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + _local(p["scale"], split).to(torch.float32))
            ).to(x.dtype)


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
    return with_spec(x, spec)


def _con_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, hd] anchored to :func:`heads_spec`."""
    return _anchor(x, heads_spec)


def _con_ff(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ..., ff] anchored to :func:`ff_spec` (the MLP hidden)."""
    return _anchor(x, ff_spec)


def seq_spec(mesh, shape: tuple) -> tuple:
    """[B, S, ...] → the sequence-parallel carry: batch over the batch
    axes, S over ``model`` when it divides (JAX's ``act_spec``, guarded)."""
    model = "model" in mesh.axis_names
    s_ax = "model" if model and shape[1] % mesh.shape["model"] == 0 else None
    return (_batch_ax(mesh, shape[0]), s_ax) + (None,) * (len(shape) - 2)


class SeqParallel:
    """JAX's sequence-parallel ``act_constraint`` (the layer carry anchored
    to ``act_spec``) for :meth:`~repro_torch.models.transformer.LM.apply`.
    Called on the carry it anchors a DTensor to :func:`seq_spec` and passes
    a plain tensor (one process holding it whole) unchanged.  Under weights
    that are DTensors over a model axis of m > 1 ranks dividing S
    (:meth:`line`), ``LM.apply`` keeps each rank's [B, S/m, d] part of the
    carry between layers: the norms and the residual adds run on the part,
    the parts are gathered along S as they enter a column split
    (:func:`~repro_torch.core.spmd_pipeline.gather_seq`) and each row
    split's sum comes back as the rank's part
    (:func:`~repro_torch.core.spmd_pipeline.reduce_scatter`)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return with_spec(h, seq_spec(self.mesh, tuple(h.shape)))

    @staticmethod
    def line(weight, seq_len: int) -> tuple | None:
        """(process group, transport) of the model axis when the carry of
        ``seq_len`` tokens is split: ``weight`` a DTensor over a model axis
        of m > 1 ranks and m dividing ``seq_len`` (the guard leaves S whole
        otherwise); else None."""
        if not is_dtensor(weight):
            return None
        names = weight.device_mesh.mesh_dim_names
        if "model" not in names:
            return None
        m = weight.device_mesh.size(names.index("model"))
        if m == 1 or seq_len % m:
            return None
        return _model_line(weight)


def attention(p: Params, x: torch.Tensor, pos=None, *, theta, window: int = 0,
              kv_x: torch.Tensor | None = None, cache: Params | None = None,
              cache_pos: int | None = None, seq: bool = False,
              data: tuple | None = None
              ) -> tuple[torch.Tensor, Params | None]:
    """Self-attention, causal (+ window), or cross-attention.

    * forward (cache=None): the whole sequence through K7;
    * prefill (cache given, ``cache_pos == 0``): k/v written into the cache
      (in place), then K7 over them — the cache rows beyond T are causally
      masked in the JAX function, so the result is the same;
    * decode (``cache_pos > 0``): plain masked softmax over the cache;
    * cross-attention (``kv_x`` [B, M, d] and no cache): q from ``x``, k
      and v from ``kv_x``, no rope and no mask, through K7 with
      ``causal=False`` (the JAX function's plain softmax below T = 2048
      and its chunked one from there are the same function).

    The weights and the cache are read through this rank's shard (the
    module docstring): q, k and v of its heads, K7 on them, and its rows of
    ``wo``; a plain tensor is a whole shard.  ``seq``: ``x`` is this rank's
    part of the tokens (:class:`SeqParallel`), and so is the output.
    ``data``: ``x`` is this rank's rows of a batch split over the data axis
    (its line, :func:`~repro_torch.core.spmd_pipeline.batch_line`), which
    the cache must hold, or hold every row of (:func:`_cache_rows`: the
    vlm self cache).
    """
    del pos                                     # positions come from T
    window = int(window)
    wq, wk, wv, wo = p["wq"], p["wk"], p["wv"], p["wo"]
    if seq and cache is not None:
        raise ValueError("a sequence-parallel carry takes no cache")
    H, hd, KV = wq.shape[1], wq.shape[2], wk.shape[1]
    heads, kv_heads = local_bounds(wq)[1], local_bounds(wk)[1]
    rows = local_bounds(wo)[0]
    if not (heads.start * hd <= rows.start and rows.stop <= heads.stop * hd):
        raise ValueError(f"attn/wo rows {rows} are not among the rows of "
                         f"this rank's heads {heads}")
    # the ranks split the use of x, wq, wk and wv when each takes its own
    # heads, and also when the heads are whole on every rank but each
    # multiplies only its rows of wo (a part of their gradients each)
    split = (heads.stop - heads.start < H
             or rows.stop - rows.start < wo.shape[0])
    x = _enter(x, wq, split, seq)
    B, T, _ = x.shape
    q = torch.einsum("btd,dnh->btnh", x, _local(wq, split))
    # the image rows, whole on every rank: a part of their gradient each
    src = x if kv_x is None else _enter(kv_x, wq, split, False)
    # the guard: kv heads whole on every rank, each reading its heads' own
    kv_read = split and kv_heads.stop - kv_heads.start == KV
    k = torch.einsum("bmd,dnh->bmnh", src, _local(wk, kv_read))
    v = torch.einsum("bmd,dnh->bmnh", src, _local(wv, kv_read))
    start = 0 if cache is None else int(cache_pos)
    q_pos = start + torch.arange(T, device=x.device)
    if kv_x is None:
        q = apply_rope(q, q_pos[None, :], theta)
        k = apply_rope(k, q_pos[None, :], theta)

    kv_lo, new_cache = kv_heads.start, None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        _cache_write(ck, _cache_part(k, wk, ck), start, data)
        _cache_write(cv, _cache_part(v, wv, cv), start, data)
        new_cache = {"k": ck, "v": cv}
        if start == 0:                          # prefill: what was written
            k, v = k.to(ck.dtype), v.to(cv.dtype)
        else:                                   # decode: the whole cache
            (k, kv_lo), (v, _) = _cache_read(ck, data), _cache_read(cv, data)
    q = _con_heads(q)
    ke = _con_heads(_kv_for_heads(k, kv_lo, heads, H // KV))
    ve = _con_heads(_kv_for_heads(v, kv_lo, heads, H // KV))
    Hl = heads.stop - heads.start
    if start == 0:                              # forward / prefill / cross
        out = ops.attention(q, ke, ve, kv_x is None,
                            window if kv_x is None else 0
                            ).reshape(B, T, Hl * hd)
    else:                                       # decode
        k_pos = torch.arange(k.shape[1], device=x.device)
        mask = attn_mask(q_pos, k_pos, window)
        scores = gqa_scores(q, ke)
        scores = torch.where(mask[None, None], scores,
                             torch.full((), NEG_INF, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = gqa_combine(probs, ve)
    out = _cut(out, 2, rows.start - heads.start * hd,
               rows.stop - heads.start * hd)
    return _row_parallel(out, wo, seq), new_cache


# --------------------------------------------------------------------------- #
# SwiGLU MLP
# --------------------------------------------------------------------------- #
def mlp_init(generator: torch.Generator, d: int, ff: int,
             dtype: torch.dtype) -> Params:
    return {"wi": _dense_init(generator, (d, 2, ff), dtype),
            "wo": _dense_init(generator, (ff, d), dtype)}


def mlp(p: Params, x: torch.Tensor, *, seq: bool = False) -> torch.Tensor:
    """SwiGLU on this rank's ff columns of ``wi`` and rows of ``wo`` (the
    whole of each for plain tensors); ``seq`` as in :func:`attention`."""
    wi, wo = p["wi"], p["wo"]
    cols, rows = local_bounds(wi)[2], local_bounds(wo)[0]
    x = _enter(x, wi, cols.stop - cols.start < wi.shape[2], seq)
    gu = _con_ff(torch.einsum("btd,dcf->btcf", x, _local(wi)))
    g, u = gu[:, :, 0], gu[:, :, 1]
    h = _con_ff(F.silu(g) * u)
    return _row_parallel(_cut(h, 2, rows.start - cols.start,
                              rows.stop - cols.start), wo, seq)


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
    atomics on the card.  Over a vocab-sharded table each rank gives the
    rows of the ids it holds and zeros for the rest, summed over the model
    axis (exact)."""
    table = p["table"]
    vb, local = local_bounds(table)[0], _local(table)
    if vb.stop - vb.start == table.shape[0]:
        return F.embedding(ids, local)
    at = ids - vb.start
    mine = (at >= 0) & (at < local.shape[0])
    rows = F.embedding(torch.where(mine, at, torch.zeros_like(at)), local)
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return all_reduce_sum(rows, *_model_line(table))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32, f32 out: bf16 operands on the card go through
    ``torch.mm(out_dtype=float32)`` (no f32 copy of either); elsewhere both
    are cast to f32, which holds their products exactly."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


class _MmF32(torch.autograd.Function):
    """:func:`_mm_f32` under autograd.  The backward takes the f32
    gradient rounded to the operands' type, exact where it is used (a row
    split's sum is rounded to the activation type, so its gradient holds
    values of that type): bf16 products summed in f32 on the card, out in
    the operands' types, as the whole layer's product's backward."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        if g.is_cuda and a.dtype == b.dtype == torch.bfloat16:
            g = g.to(a.dtype)
            return torch.mm(g, b.t()), torch.mm(a.t(), g)
        return (torch.mm(g, b.t().to(torch.float32)).to(a.dtype),
                torch.mm(a.t().to(torch.float32), g).to(b.dtype))


def bf16_terms(x: torch.Tensor) -> torch.Tensor:
    """f32 x -> [3, *x.shape] bf16 whose f32 sum is x exactly: each term
    takes the next 8 significant bits of what the ones before left over."""
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    rest = x
    for i in range(3):
        out[i] = rest
        rest = rest - out[i].to(torch.float32)
    return out


# vocab rows of the table's f32 gradient held at a time on the card: the
# whole one (gemma3's 262144 x 3840, 4.0 GB) beside its bf16 copy took 4
# ranks sharing an H100 past the card's memory
_DT_ROWS = 32768


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
        h3 = h.repeat(3, 1)
        dt = torch.empty_like(table)
        for lo in range(0, table.shape[0], _DT_ROWS):
            hi = min(lo + _DT_ROWS, table.shape[0])
            dt[lo:hi] = torch.mm(terms[:, lo:hi].t(), h3,
                                 out_dtype=torch.float32)
        return dh.reshape(3, n, -1).sum(0).to(h.dtype), dt


def logits_f32(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """h [N, d] @ table [V, d]ᵀ → [N, V] f32: the training loss's logits,
    the JAX einsum's arithmetic (products of the input type summed in f32,
    ``preferred_element_type=float32``) without an f32 copy of the table.
    The backward keeps the f32 gradient g as it is, as JAX's transpose rule
    does (``lax._dot_general_transpose_lhs``/``_rhs`` multiply the f32
    cotangent by the other operand with ``preferred_element_type`` f32): on
    the card g goes in as the three bf16 terms of :func:`bf16_terms`, so
    each product is bf16 x bf16 summed in f32 and equals the f32 product
    up to the order of sums.  f32 sums come out in the inputs' types; the
    table's is summed :data:`_DT_ROWS` vocab rows at a time, each block
    rounded to the table's type as it is done."""
    return _LogitsF32.apply(h, table)


def lm_logits(p: Params, h: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, T, d] → [B, T, vocab] f32 (products of the input type, summed in
    f32, as the JAX einsum's ``preferred_element_type``), without an f32
    copy of the table.  Over a vocab-sharded table each rank's rows'
    logits, gathered over the model axis."""
    B, T, d = h.shape
    table = p["table"]
    vb = local_bounds(table)[0]
    if vb.stop - vb.start == table.shape[0]:
        return _mm_f32(h.reshape(B * T, d),
                       _local(table)[:vocab].t()).reshape(B, T, vocab)
    part = _mm_f32(h.reshape(B * T, d), _local(table).t())
    part = all_gather_cat(part, 1, *_model_line(table))
    return part[:, :vocab].reshape(B, T, vocab)


# --------------------------------------------------------------------------- #
# This rank's shard of a weight (tensor parallelism)
# --------------------------------------------------------------------------- #
def _local(x, split: bool = False):
    """This rank's part of weight ``x``: a DTensor's local tensor (no
    communication), a plain tensor as it is.

    The one rule for the gradient of a leaf that every rank holds whole (a
    DTensor replicated over the model axis): it is summed over the model
    axis exactly when the ranks split the leaf's use (``split``: each rank
    reads it for its own part — its tokens under sequence parallelism, its
    heads' kv heads under the guard), so each rank's gradient is a part of
    the whole.  Where every rank's use is the whole one, each rank's
    gradient is already the whole, and a sum would make it m times too
    large.  A sharded leaf's gradient is this rank's own part either way.

    The moe block meets the rule without a split read: its router (and the
    norm before it) is used whole by the routing, whose aux losses give
    every rank the whole gradient, and split by the experts, whose part
    of the gradient is summed where it arises, on the gates and on the
    dispatched tokens (:mod:`repro_torch.models.moe`); so the router is
    read with ``split`` False and its gradient, whole, is not summed.
    """
    if not is_dtensor(x):
        return x
    local = x.to_local()
    names = x.device_mesh.mesh_dim_names
    if (split and local.requires_grad and "model" in names
            and not x.placements[names.index("model")].is_shard()):
        return copy_to_ranks(local, *_model_line(x))
    return local


def gather_data(tree: Params, data) -> Params:
    """``tree``'s weights with their ``data`` (FSDP storage) dim gathered
    over the data axis (:func:`~repro_torch.core.spmd_pipeline.unshard`),
    still split over ``model``; plain tensors and leaves whole over
    ``data`` unchanged.  ``data``: the (process group, transport) over
    which the batch is split
    (:func:`~repro_torch.core.spmd_pipeline.batch_line`), or None.  The
    rule of :func:`_local`, for the data axis: the gradient is summed over
    the axis exactly when the batch is split over it (each rank's rows
    give a part of it); with the batch whole on every rank each rank's
    gradient is already the whole, and it keeps its part."""
    return tree_map(lambda a: unshard(a, "data", data is not None), tree)


def _state_rows(state, rows: int, data, what: str) -> None:
    """Raise unless ``state`` (a recurrent state or a k/v cache leaf, or
    an input beside the batch such as the vlm image embeddings; B its dim
    0; ``what`` names it) holds the rows of B that the activations hold:
    as many (``rows``), and split over the same ranks as the batch
    (``data``, the batch's line,
    :func:`~repro_torch.core.spmd_pipeline.batch_line`; None where the
    batch is whole here, and then so must B be), so that a rank's state is
    its own rows and not another rank's or a whole batch's."""
    at = local_bounds(state)[0]
    ranks = [None if line is None
             else torch.distributed.get_process_group_ranks(line[0])
             for line in (batch_line(state), data)]
    if at.stop - at.start != rows or ranks[0] != ranks[1]:
        raise ValueError(f"the {what} holds rows {at} of its batch "
                         f"of {state.shape[0]}, split over ranks "
                         f"{ranks[0]}; the activations {rows} rows, split "
                         f"over ranks {ranks[1]}")


def _cut(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """``x``'s indices ``lo..hi-1`` along ``dim``; ``x`` itself when that
    is all of it."""
    if lo == 0 and hi == x.shape[dim]:
        return x
    return x.narrow(dim, lo, hi - lo)


def _model_line(w) -> tuple:
    """(process group, transport) of DTensor ``w``'s ``model`` mesh axis
    (or a :class:`~repro_torch.core.spmd_pipeline.HeldBy` layer's)."""
    group = w.device_mesh.get_group("model")
    device = w.device if isinstance(w, HeldBy) else w.to_local().device
    return group, group_transport(group, device)


def _enter(x: torch.Tensor, w, split: bool, seq: bool) -> torch.Tensor:
    """``x`` as it enters a product with DTensor ``w``'s local columns
    (``split``: some of w's columns, not all).  ``x`` is whole on every
    rank and passes as it is, its gradient summed over the model axis when
    split (each rank's columns give a part of it,
    :func:`~repro_torch.core.spmd_pipeline.copy_to_ranks`); or, ``seq``,
    ``x`` is this rank's part of the tokens, gathered along S (the
    gradient then summed likewise and this rank's part kept,
    :func:`~repro_torch.core.spmd_pipeline.gather_seq`).  A plain ``w``:
    ``x`` as it is."""
    if not is_dtensor(w):
        return x
    line = _model_line(w)
    if seq:
        return (gather_seq if split else all_gather_cat)(x, 1, *line)
    return copy_to_ranks(x, *line) if split else x


def _row_parallel(h: torch.Tensor, w, seq: bool = False) -> torch.Tensor:
    """[B, T, f] h @ w [F, d], h holding w's local rows: the one-process
    product when they are all of w's rows, else a partial product in f32
    summed over the model axis and rounded once to h's type.  ``seq``: the
    result is this rank's part of the tokens (the sum's part, or the
    whole product's)."""
    rows = local_bounds(w)[0]
    if rows.stop - rows.start == w.shape[0]:
        y = torch.einsum("btf,fd->btd", h, _local(w))
        return own_part(y, 1, *_model_line(w)) if seq else y
    B, T, f = h.shape
    part = _MmF32.apply(h.reshape(B * T, f), _local(w))
    line = _model_line(w)
    if seq:
        return reduce_scatter(part.reshape(B, T, -1), 1, *line).to(h.dtype)
    return all_reduce_sum(part, *line).to(h.dtype).reshape(B, T, -1)


def _cache_part(kv: torch.Tensor, w, cache) -> torch.Tensor:
    """This rank's k or v [B, T, n, hd] (the kv heads of its columns of
    weight ``w``, at the whole head_dim) re-laid as the part of them that
    the k/v ``cache`` [B, M, KV, hd] keeps here: its kv heads at its
    head_dim columns.  Where the cache keeps kv heads the rank does not
    compute (the vlm caches' layout: every kv head at a part of head_dim,
    while ``w`` splits the kv heads), the ranks' kv heads are gathered
    first."""
    kv_heads, cb = local_bounds(w)[1], local_bounds(cache)
    lo = kv_heads.start
    if cb[2].start < kv_heads.start or cb[2].stop > kv_heads.stop:
        if cb[2].stop - cb[2].start != cache.shape[2]:
            raise ValueError(f"cache kv heads {cb[2]} are not among this "
                             f"rank's {kv_heads}")
        kv, lo = all_gather_cat(kv.contiguous(), 2, *_model_line(w)), 0
    return _cut(_cut(kv, 2, cb[2].start - lo, cb[2].stop - lo), 3,
                cb[3].start, cb[3].stop)


def _cache_rows(cache, rows: int, data) -> bool:
    """Whether k/v ``cache`` [B, M, KV, hd] (a layer's leaf, or its
    :class:`~repro_torch.core.spmd_pipeline.HeldBy` record) holds every row
    of the global batch while the activations hold a data rank's ``rows``
    of it (True: the vlm self cache, whose JAX layout splits its per-group
    dim over ``data`` and keeps B whole), or the activations' own rows
    (False: :func:`_state_rows`'s rule, B split as the batch is); any
    other layout raises."""
    at = local_bounds(cache)[0]
    if (data is not None and at.stop - at.start == cache.shape[0]
            and batch_line(cache) is None
            and cache.shape[0] == rows * dist.get_world_size(data[0])):
        return True
    _state_rows(cache, rows, data, "k/v cache")
    return False


def _cache_write(cache, part: torch.Tensor, start: int, data) -> None:
    """Write ``part`` [rows, T, ...] (this rank's rows of the new k or v,
    re-laid by :func:`_cache_part`) into k/v ``cache`` at positions
    ``start..start+T-1``.  Where the cache holds every row of the batch
    (:func:`_cache_rows`) the ranks' rows are gathered over ``data`` first,
    in rank order and exact; then the rank that holds the layer writes
    them (all of them where the layer is whole over ``data``, each a bit
    equal replica; only the owner of a
    :class:`~repro_torch.core.spmd_pipeline.HeldBy` layer)."""
    part = part.to(cache.dtype)
    if _cache_rows(cache, part.shape[0], data):
        part = all_gather_cat(part.contiguous(), 0, *data)
    if isinstance(cache, HeldBy):
        if cache.layer is None:
            return
        cache = cache.layer
    _local(cache)[:, start:start + part.shape[1]] = part


def _cache_read(cache, data=None) -> tuple[torch.Tensor, int]:
    """(the k/v ``cache`` [B, M, KV, hd] kept here at the whole head_dim,
    gathered where the head_dim is split; the first kv head it holds), of
    the activations' rows: where the cache holds every row of a batch
    split over ``data`` (:func:`_cache_rows`), this rank's part of them,
    its own slice of a layer held whole, or, of a
    :class:`~repro_torch.core.spmd_pipeline.HeldBy` layer, the rows its
    owner sends (:func:`~repro_torch.core.spmd_pipeline.held_rows`; every
    rank of the data axis joins the exchange)."""
    cb = local_bounds(cache)
    if isinstance(cache, HeldBy):
        local = held_rows(cache, data is not None)
    else:
        local = _local(cache)
        if data is not None and batch_line(cache) is None:
            n = local.shape[0] // dist.get_world_size(data[0])
            local = local.narrow(0, dist.get_rank(data[0]) * n, n)
    if cb[3].stop - cb[3].start != cache.shape[3]:
        local = all_gather_cat(local.contiguous(), 3, *_model_line(cache))
    return local, cb[2].start


def _kv_for_heads(kv: torch.Tensor, kv_lo: int, heads: slice,
                  G: int) -> torch.Tensor:
    """The [B, M, h, hd] k or v that q heads ``heads`` read (G q heads a
    kv head), from ``kv`` [B, M, n, hd] holding kv heads
    ``kv_lo..kv_lo+n-1``: :func:`expand_kv` of their kv heads when the
    heads are whole groups (with the kv heads sharded: all the rank holds,
    no communication), else a take of each head's kv head."""
    h = heads.stop - heads.start
    if heads.start % G == 0 and h % G == 0:
        lo = heads.start // G - kv_lo
        return expand_kv(_cut(kv, 2, lo, lo + h // G), h)
    idx = torch.arange(heads.start, heads.stop, device=kv.device) // G
    return kv.index_select(2, idx - kv_lo)
