"""RWKV-6 "Finch" block — the port of the JAX package's ``models/rwkv.py``:
attention-free token mixing with data-dependent decay.

Per head (hd=64), the time-mix recurrence over a matrix-valued state S:

    y_t = r_t · (S_{t-1} + (u ∘ k_t) ⊗ v_t)
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

where the decay w_t = exp(-exp(wb + lora(x_t))) is *data-dependent* — the
RWKV-6 signature (arXiv:2404.05892).  ``w`` and ``u`` both scale S along
the key axis i (``S[i, j]``).  Channel-mix is the squared-ReLU FFN.
Decode carries (S, token-shift) state.

The recurrence is :func:`~.scan_utils.chunked_scan` over time in f32, in
blocks of 256 steps: a block's ``k ⊗ v`` and ``u ∘ (k ⊗ v)`` are computed
for all its steps before they run, so each step launches the add of the
bonus, one product for y (a ``bmm`` over the B*H heads, the shapes of one
step whatever T is, so a decode step and a prefill's step sum alike) and
one fused multiply-add on S.

Tensor parallelism (weights as DTensors by ``param_shardings(_serving)``,
a state by ``cache_shardings``; :mod:`.layers`' module docstring): ``wr``,
``wk``, ``wv``, ``wg`` and ``cr`` are split by columns of d, ``ck`` by
columns of ff, ``wo`` and ``cv`` by rows.  A rank's columns are whole
heads of 64 when they start and end on a head; it then runs the scan, the
group norm and the bonus on its heads alone.  Where its columns cut a
head, r, k, v and w are gathered to every head (their gradients, a part on
each rank, summed) and every rank runs the whole scan, keeping its columns
after the group norm.  The leaves held whole (``mu``, ``w_bias``,
``w_lora_a``, ``w_lora_b``, ``u``, ``ln_scale``, ``mu_c``) are read for
the rank's columns, so their gradients are summed
(:func:`~.layers._local`).  Channel-mix sums ``k @ cv``'s partial products
into the rank's columns of d (a reduce-scatter), where they meet
``sigmoid(xr @ cr)``'s same columns; the block's output is then gathered
along d.  The state keeps the cache's layout: ``S`` [B, H, hd, hd] split
on its last dim (the cache path is ``S``, so the general rule shards its
last dim) is gathered along it as a step comes in and re-laid from the
rank's heads as it goes out; ``tm_last`` and ``cm_last`` [B, d], split on
d, are gathered to be read, and each rank stores its columns.  Under a
data axis (and ``pod`` beside it) every state leaf holds the rank's rows
of B over the batch's line, the activations' rows (checked as it is read); the gathers above run over the model axis
alone and leave the rows as they are.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.spmd_pipeline import (all_gather_cat, gather_seq, is_dtensor,
                                   local_bounds, own_part, reduce_scatter)
from .layers import (_MmF32, _cut, _dense_init, _enter, _local, _model_line,
                     _row_parallel, _state_rows, rmsnorm)
from .scan_utils import chunked_scan

Params = Any
HEAD_DIM = 64


def rwkv_init(generator: torch.Generator, d: int, ff: int,
              dtype: torch.dtype, lora_rank: int = 32) -> Params:
    """``mu``, ``w_bias``, ``u``, ``ln_scale`` and ``mu_c`` in f32 (zeros,
    ones for ``ln_scale``), the rest in ``dtype``."""
    H = d // HEAD_DIM
    dev = generator.device

    def f32(shape, value=0.0):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        # time-mix
        "mu": f32((5, d)),                               # shift-mix r,k,v,w,g
        "wr": _dense_init(generator, (d, d), dtype),
        "wk": _dense_init(generator, (d, d), dtype),
        "wv": _dense_init(generator, (d, d), dtype),
        "wg": _dense_init(generator, (d, d), dtype),
        "w_bias": f32((d,)),
        "w_lora_a": _dense_init(generator, (d, lora_rank), dtype),
        "w_lora_b": _dense_init(generator, (lora_rank, d), dtype,
                                scale=0.01),
        "u": f32((H, HEAD_DIM)),                         # bonus
        "ln_scale": f32((d,), 1.0),                      # per-head group norm
        "wo": _dense_init(generator, (d, d), dtype),
        # channel-mix
        "mu_c": f32((2, d)),
        "ck": _dense_init(generator, (d, ff), dtype),
        "cv": _dense_init(generator, (ff, d), dtype),
        "cr": _dense_init(generator, (d, d), dtype),
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """Previous-token sequence shift; ``last`` is the [B, d] decode carry."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _whole_d(last: torch.Tensor | None) -> torch.Tensor | None:
    """A [B, d] token-shift state held whole: a DTensor's parts gathered
    along d; a plain tensor as it is."""
    if not is_dtensor(last):
        return last
    local, at = last.to_local(), local_bounds(last)[1]
    if at.stop - at.start == last.shape[1]:
        return local
    return all_gather_cat(local.contiguous(), 1, *_model_line(last))


def _d_part(t: torch.Tensor, leaf) -> torch.Tensor:
    """[B, d] ``t`` cut to the columns of d that state ``leaf`` holds on
    this rank (all of them for a plain ``leaf``)."""
    at = local_bounds(leaf)[1]
    return _cut(t, 1, at.start, at.stop)


def _scan_state(S0: torch.Tensor, hs: slice) -> torch.Tensor:
    """Heads ``hs`` of state ``S0`` [B, H, hd, hd], whole along its last
    dim: a DTensor laid out by ``cache_shardings`` is gathered along it."""
    if is_dtensor(S0):
        at = local_bounds(S0)
        if at[1].stop - at[1].start != S0.shape[1]:
            raise ValueError(f"the rwkv state's heads are split ({at[1]})")
        S = S0.to_local()
        if at[3].stop - at[3].start != S0.shape[3]:
            S = all_gather_cat(S.contiguous(), 3, *_model_line(S0))
        S0 = S
    return _cut(S0, 1, hs.start, hs.stop)


def _cache_layout(S_T: torch.Tensor, hs: slice, S0) -> torch.Tensor:
    """The new state of heads ``hs`` in DTensor ``S0``'s layout: the
    ranks' heads gathered, then this rank's part of the last dim."""
    if hs.stop - hs.start < S0.shape[1]:
        S_T = all_gather_cat(S_T.contiguous(), 1, *_model_line(S0))
    at = local_bounds(S0)[3]
    return _cut(S_T, 3, at.start, at.stop)


def time_mix(p: Params, x: torch.Tensor, S0: torch.Tensor,
             last: torch.Tensor | None, *, remat: bool = True,
             seq: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B,T,d]; S0: [B,H,hd,hd] f32. Returns (y, S_T).  ``remat=False``
    runs the scan's blocks without checkpoints.

    Under DTensor weights (the module docstring) each rank runs its
    columns; ``last`` is whole; S0, a DTensor by ``cache_shardings``,
    gives S_T as the local tensor of its layout, and a plain S0 (whole)
    gives S_T of the heads the rank ran.  ``seq``: ``x`` is this rank's
    part of the tokens (:class:`~.layers.SeqParallel`), gathered along S
    for the shift and the scan, and so is ``y``."""
    wr = p["wr"]
    cols = local_bounds(wr)[1]
    lo, hi = cols.start, cols.stop
    split = hi - lo < wr.shape[1]
    rows = local_bounds(p["wo"])[0]
    if (rows.start, rows.stop) != (lo, hi):
        raise ValueError(f"rwkv/wo rows {rows} are not this rank's "
                         f"columns {cols}")
    x = _enter(x, wr, split, seq)
    B, T, d = x.shape
    H = d // HEAD_DIM
    with record_function("rwkv:time_mix"):
        xx = _shift(x, last)
        mu = _local(p["mu"], split).to(x.dtype)
        xr, xk, xv, xw, xg = (x + (xx - x) * mu[i] for i in range(5))
        r = torch.einsum("btd,de->bte", xr, _local(wr))
        k = torch.einsum("btd,de->bte", xk, _local(p["wk"]))
        v = torch.einsum("btd,de->bte", xv, _local(p["wv"]))
        g = F.silu(torch.einsum("btd,de->bte", xg, _local(p["wg"])))
        # data-dependent decay (RWKV-6 lora), f32
        wlog = _cut(_local(p["w_bias"], split), 0, lo, hi) + (
            xw.to(torch.float32)
            @ _local(p["w_lora_a"], split).to(torch.float32)
            @ _cut(_local(p["w_lora_b"], split), 1, lo, hi).to(
                torch.float32))
        w = torch.exp(-torch.exp(wlog))                          # (0,1)
        if lo % HEAD_DIM == 0 and hi % HEAD_DIM == 0:
            hs = slice(lo // HEAD_DIM, hi // HEAD_DIM)           # its heads
        else:                       # its columns cut a head: every head
            line = _model_line(wr)
            r, k, v, w = (gather_seq(a.contiguous(), 2, *line)
                          for a in (r, k, v, w))
            hs = slice(0, H)
        nh = hs.stop - hs.start
        r, k, v, w = (a.reshape(B, T, nh, HEAD_DIM) for a in (r, k, v, w))
    u = _cut(_local(p["u"], split), 0, hs.start, hs.stop)[..., :, None]
    BH = B * nh

    def prep(inp):                         # [c, B, nh, hd] each
        r, k, v, w = inp
        c = r.shape[0]
        kv = k[..., :, None] * v[..., None, :]                   # [c,B,H,i,j]
        return (r.reshape(c, BH, 1, HEAD_DIM), kv.reshape(c, BH, HEAD_DIM,
                                                          HEAD_DIM),
                (u * kv).reshape(c, BH, HEAD_DIM, HEAD_DIM),
                w.reshape(c, BH, HEAD_DIM, 1))

    def step(S, inp):                      # S: [B*nh, i, j]
        r, kv, ukv, w = inp
        y = torch.bmm(r, S + ukv)                                # [B*H,1,hd]
        return torch.addcmul(kv, w, S), y

    xs = tuple(a.to(torch.float32).transpose(0, 1) for a in (r, k, v, w))
    with record_function("rwkv:scan"):
        S_T, ys = chunked_scan(step, _scan_state(S0, hs).reshape(
                                   BH, HEAD_DIM, HEAD_DIM), xs,
                               prep=prep, remat=remat,
                               chunk=256 if T % 256 == 0 else 0)
    S_T = S_T.reshape(B, nh, HEAD_DIM, HEAD_DIM)
    if is_dtensor(S0):
        S_T = _cache_layout(S_T, hs, S0)
    with record_function("rwkv:time_mix"):
        y = ys.reshape(T, B, nh, HEAD_DIM).transpose(0, 1)      # [B,T,H,hd]
        # per-head group norm (population variance, as jnp.var)
        y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
            y.var(-1, keepdim=True, correction=0) + 1e-5)
        y = _cut(y.reshape(B, T, nh * HEAD_DIM), 2,
                 lo - hs.start * HEAD_DIM, hi - hs.start * HEAD_DIM)
        y = (y * _cut(_local(p["ln_scale"], split), 0, lo, hi)
             ).to(x.dtype) * g
        return _row_parallel(y, p["wo"], seq), S_T


def channel_mix(p: Params, x: torch.Tensor, last: torch.Tensor | None, *,
                seq: bool = False) -> torch.Tensor:
    """The squared-ReLU FFN.  Under DTensor weights each rank runs its ff
    columns of ``ck`` and rows of ``cv`` and its d columns of ``cr`` (the
    module docstring); ``last`` is whole; ``seq`` as in :func:`time_mix`."""
    ck, cv, cr = p["ck"], p["cv"], p["cr"]
    fcols, dcols = local_bounds(ck)[1], local_bounds(cr)[1]
    split = fcols.stop - fcols.start < ck.shape[1]
    if split != (dcols.stop - dcols.start < cr.shape[1]):
        raise NotImplementedError(
            f"rwkv channel-mix with ck's columns {fcols} of "
            f"{ck.shape[1]} and cr's {dcols} of {cr.shape[1]}: one split, "
            f"the other whole, is not done here")
    x = _enter(x, ck, split, seq)
    with record_function("rwkv:channel_mix"):
        xx = _shift(x, last)
        mu = _local(p["mu_c"], split).to(x.dtype)
        xk = x + (xx - x) * mu[0]
        xr = x + (xx - x) * mu[1]
        k = torch.einsum("btd,df->btf", xk, _local(ck))
        k = torch.square(F.relu(k))
        if not split:
            kv = torch.einsum("btf,fd->btd", k, _local(cv))
            out = torch.sigmoid(torch.einsum("btd,de->bte", xr,
                                             _local(cr))) * kv
            return own_part(out, 1, *_model_line(ck)) if seq else out
        line = _model_line(ck)
        B, T, f = k.shape
        part = _MmF32.apply(k.reshape(B * T, f), _local(cv))
        kv = reduce_scatter(part.reshape(B, T, -1), 2, *line).to(x.dtype)
        out = all_gather_cat(torch.sigmoid(torch.einsum(
            "btd,de->bte", xr, _local(cr))) * kv, 2, *line)
        return own_part(out, 1, *line) if seq else out


def rwkv_block(p: Params, x: torch.Tensor, norm1: Params, norm2: Params,
               state: Params | None = None, *, seq: bool = False,
               data=None) -> tuple[torch.Tensor, Params]:
    """Full RWKV block: time-mix + channel-mix with residuals.

    ``state`` = {"S": [B,H,hd,hd] f32, "tm_last": [B,d], "cm_last": [B,d]};
    DTensors by ``cache_shardings`` under DTensor weights, and then the
    new state holds the local tensors of their layout.  ``seq``: ``x`` is
    this rank's part of the tokens, and so is the result (no state).
    ``data``: x is this rank's rows of a batch split over that data line
    (:func:`~repro_torch.core.spmd_pipeline.batch_line`), as ``state``'s
    must be (:func:`~.layers._state_rows`)."""
    B, T, d = x.shape
    H = d // HEAD_DIM
    if state is None:
        S0, tm_last, cm_last = (
            torch.zeros((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device=x.device), None, None)
    else:
        for k in ("S", "tm_last", "cm_last"):
            _state_rows(state[k], B, data, "rwkv state")
        S0, tm_last, cm_last = (state["S"], _whole_d(state["tm_last"]),
                                _whole_d(state["cm_last"]))
    h1 = rmsnorm(norm1, x, split=seq)
    y, S_T = time_mix(p, h1, S0, tm_last, seq=seq)
    x = x + y
    h2 = rmsnorm(norm2, x, split=seq)
    x = x + channel_mix(p, h2, cm_last, seq=seq)
    if state is None:
        return x, {"S": S_T, "tm_last": h1[:, -1], "cm_last": h2[:, -1]}
    return x, {"S": S_T, "tm_last": _d_part(h1[:, -1], state["tm_last"]),
               "cm_last": _d_part(h2[:, -1], state["cm_last"])}


def rwkv_init_state(batch: int, d: int, dtype: torch.dtype,
                    device=None) -> Params:
    H = d // HEAD_DIM
    return {"S": torch.zeros((batch, H, HEAD_DIM, HEAD_DIM),
                             dtype=torch.float32, device=device),
            "tm_last": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_last": torch.zeros((batch, d), dtype=dtype, device=device)}
