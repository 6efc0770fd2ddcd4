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
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import _dense_init, rmsnorm
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


def time_mix(p: Params, x: torch.Tensor, S0: torch.Tensor,
             last: torch.Tensor | None, *, remat: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B,T,d]; S0: [B,H,hd,hd] f32. Returns (y, S_T).  ``remat=False``
    runs the scan's blocks without checkpoints."""
    B, T, d = x.shape
    H = d // HEAD_DIM
    with record_function("rwkv:time_mix"):
        xx = _shift(x, last)
        mu = p["mu"].to(x.dtype)
        xr, xk, xv, xw, xg = (x + (xx - x) * mu[i] for i in range(5))
        r = torch.einsum("btd,de->bte", xr, p["wr"]).reshape(B, T, H,
                                                             HEAD_DIM)
        k = torch.einsum("btd,de->bte", xk, p["wk"]).reshape(B, T, H,
                                                             HEAD_DIM)
        v = torch.einsum("btd,de->bte", xv, p["wv"]).reshape(B, T, H,
                                                             HEAD_DIM)
        g = F.silu(torch.einsum("btd,de->bte", xg, p["wg"]))
        # data-dependent decay (RWKV-6 lora), f32
        wlog = p["w_bias"] + (xw.to(torch.float32)
                              @ p["w_lora_a"].to(torch.float32)
                              @ p["w_lora_b"].to(torch.float32))
        w = torch.exp(-torch.exp(wlog)).reshape(B, T, H, HEAD_DIM)  # (0,1)
    u = p["u"][..., :, None]                                     # [H,hd,1]
    BH = B * H

    def prep(inp):                         # [c, B, H, hd] each
        r, k, v, w = inp
        c = r.shape[0]
        kv = k[..., :, None] * v[..., None, :]                   # [c,B,H,i,j]
        return (r.reshape(c, BH, 1, HEAD_DIM), kv.reshape(c, BH, HEAD_DIM,
                                                          HEAD_DIM),
                (u * kv).reshape(c, BH, HEAD_DIM, HEAD_DIM),
                w.reshape(c, BH, HEAD_DIM, 1))

    def step(S, inp):                      # S: [B*H, i, j]
        r, kv, ukv, w = inp
        y = torch.bmm(r, S + ukv)                                # [B*H,1,hd]
        return torch.addcmul(kv, w, S), y

    xs = tuple(a.to(torch.float32).transpose(0, 1) for a in (r, k, v, w))
    with record_function("rwkv:scan"):
        S_T, ys = chunked_scan(step, S0.reshape(BH, HEAD_DIM, HEAD_DIM), xs,
                               prep=prep, remat=remat,
                               chunk=256 if T % 256 == 0 else 0)
    S_T = S_T.reshape(B, H, HEAD_DIM, HEAD_DIM)
    with record_function("rwkv:time_mix"):
        y = ys.reshape(T, B, H, HEAD_DIM).transpose(0, 1)       # [B,T,H,hd]
        # per-head group norm (population variance, as jnp.var)
        y = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
            y.var(-1, keepdim=True, correction=0) + 1e-5)
        y = (y.reshape(B, T, d) * p["ln_scale"]).to(x.dtype) * g
        return torch.einsum("btd,de->bte", y, p["wo"]), S_T


def channel_mix(p: Params, x: torch.Tensor,
                last: torch.Tensor | None) -> torch.Tensor:
    with record_function("rwkv:channel_mix"):
        xx = _shift(x, last)
        mu = p["mu_c"].to(x.dtype)
        xk = x + (xx - x) * mu[0]
        xr = x + (xx - x) * mu[1]
        k = torch.einsum("btd,df->btf", xk, p["ck"])
        k = torch.square(F.relu(k))
        kv = torch.einsum("btf,fd->btd", k, p["cv"])
        return torch.sigmoid(torch.einsum("btd,de->bte", xr, p["cr"])) * kv


def rwkv_block(p: Params, x: torch.Tensor, norm1: Params, norm2: Params,
               state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Full RWKV block: time-mix + channel-mix with residuals.

    ``state`` = {"S": [B,H,hd,hd] f32, "tm_last": [B,d], "cm_last": [B,d]}.
    """
    B, T, d = x.shape
    H = d // HEAD_DIM
    if state is None:
        S0, tm_last, cm_last = (
            torch.zeros((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device=x.device), None, None)
    else:
        S0, tm_last, cm_last = state["S"], state["tm_last"], state["cm_last"]
    h1 = rmsnorm(norm1, x)
    y, S_T = time_mix(p, h1, S0, tm_last)
    x = x + y
    h2 = rmsnorm(norm2, x)
    x = x + channel_mix(p, h2, cm_last)
    return x, {"S": S_T, "tm_last": h1[:, -1], "cm_last": h2[:, -1]}


def rwkv_init_state(batch: int, d: int, dtype: torch.dtype,
                    device=None) -> Params:
    H = d // HEAD_DIM
    return {"S": torch.zeros((batch, H, HEAD_DIM, HEAD_DIM),
                             dtype=torch.float32, device=device),
            "tm_last": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_last": torch.zeros((batch, d), dtype=dtype, device=device)}
