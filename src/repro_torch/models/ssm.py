"""Selective SSM (Mamba-style) branch — the port of the JAX package's
``models/ssm.py``, used by the Hymba hybrid block.

Continuous-time selective state space, discretized per token:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t          (state: [di, N])
    y_t = C_t . h_t + D * x_t

with input-dependent dt/B/C ("selective").  The sequential form is
:func:`~.scan_utils.chunked_scan` over time, blocks of 256 steps; decode
carries (conv_state, ssm_state) explicitly.  A block's ``exp(dt * A)`` and
``(dt * B) * x`` are computed for all its steps at once, before its steps
run, and ``C . h`` for all of them after, so each step launches one fused
multiply-add on the carry.  The recurrence runs in f32 on the input's
device.

The conv tail rule is the reference's (``ssm_apply``): with T < K - 1 and
no state, the new conv state is zeros and the tokens are not kept.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import _dense_init
from .scan_utils import chunked_scan

Params = Any


def ssm_init(generator: torch.Generator, d: int, state: int, conv_k: int,
             dtype: torch.dtype) -> Params:
    """``dt_bias``, ``A_log`` and ``D`` in f32 (zeros, zeros, ones), the
    rest in ``dtype``."""
    di = d                          # inner dim = d (heads split in hymba)
    dev = generator.device
    return {
        "in_proj": _dense_init(generator, (d, 2, di), dtype),
        "conv": _dense_init(generator, (conv_k, di), dtype,
                            scale=conv_k ** -0.5),
        "w_dt": _dense_init(generator, (di, di), dtype, scale=di ** -0.5),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        "w_bc": _dense_init(generator, (di, 2, state), dtype),
        "A_log": torch.zeros((di, state), dtype=torch.float32, device=dev),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(generator, (di, d), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 init_state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. x: [B, T, di], w: [K, di]."""
    K, T = w.shape[0], x.shape[1]
    if init_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_state
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out


def _ssm_core(p: Params, xc: torch.Tensor, h0: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """xc: [B, T, di] (post-conv, pre-activation). Returns (y, h_T)."""
    xc = F.silu(xc)
    dt = F.softplus(torch.einsum("btd,de->bte", xc, p["w_dt"])
                    .to(torch.float32) + p["dt_bias"])           # [B,T,di]
    bc = torch.einsum("btd,dcn->btcn", xc, p["w_bc"]).to(torch.float32)
    Bt, Ct = bc[:, :, 0], bc[:, :, 1]                             # [B,T,N]
    A = -torch.exp(p["A_log"])                                    # [di,N]

    def prep(inp):          # [c, B, di], [c, B, di], [c, B, N], [c, B, N]
        x, dt, b, c = inp
        dA = torch.exp(dt[..., None] * A)                         # [c,B,di,N]
        dBx = dt[..., None] * b[:, :, None, :] * x[..., None].to(
            torch.float32)
        return dA, dBx, c

    def step(h, inp):
        dA, dBx, _ = inp
        h = torch.addcmul(dBx, dA, h)
        return h, h

    def post(inp, hs):                       # y = C . h, a block at once
        return torch.matmul(hs, inp[2][..., None])[..., 0]         # [c,B,di]

    xs = tuple(a.transpose(0, 1) for a in (xc, dt, Bt, Ct))
    T = xc.shape[1]
    with record_function("ssm:scan"):
        hT, ys = chunked_scan(step, h0, xs, prep=prep, post=post,
                              chunk=256 if T % 256 == 0 else 0)
    y = ys.transpose(0, 1) + p["D"] * xc.to(torch.float32)       # [B,T,di]
    return y, hT


def ssm_apply(p: Params, x: torch.Tensor, state: Params | None = None
              ) -> tuple[torch.Tensor, Params]:
    """Full-sequence (train/prefill), or decode from ``state``.
    x: [B,T,d] → (y [B,T,d], {"h": [B,d,N] f32, "conv": [B,K-1,d]})."""
    B, T, d = x.shape
    N = p["A_log"].shape[1]
    xz = torch.einsum("btd,dci->btci", x, p["in_proj"])
    xi, z = xz[:, :, 0], xz[:, :, 1]
    with record_function("ssm:conv"):
        xc = _causal_conv(xi, p["conv"],
                          state["conv"] if state is not None else None)
    h0 = (state["h"] if state is not None else
          torch.zeros((B, d, N), dtype=torch.float32, device=x.device))
    y, hT = _ssm_core(p, xc, h0)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("btd,de->bte", y, p["out_proj"])
    K = p["conv"].shape[0]
    if T >= K - 1:
        tail = xi[:, T - (K - 1):]
    elif state is not None:
        tail = torch.cat([state["conv"][:, T:], xi], dim=1)
    else:                   # the reference's zero tail (ROADMAP.md queue 3)
        tail = torch.zeros((B, K - 1, d), dtype=x.dtype, device=x.device)
    return out, {"h": hT, "conv": tail}


def ssm_init_state(batch: int, d: int, state: int, conv_k: int,
                   dtype: torch.dtype, device=None) -> Params:
    return {"h": torch.zeros((batch, d, state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_k - 1, d), dtype=dtype,
                                device=device)}
