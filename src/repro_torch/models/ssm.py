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

Tensor parallelism (weights as DTensors by ``param_shardings(_serving)``,
a state by ``cache_shardings``; :mod:`.layers`' module docstring):
``in_proj`` is split on its inner channels, so each rank holds the x and z
halves of its channels and runs the conv, the scan, ``D`` and ``silu(z)``
on them alone, its state ``h`` [B, di/m, N] and ``conv`` [B, K-1, di/m]
being its shards of the cache's.  The leaves held whole (``conv``,
``w_dt``, ``dt_bias``, ``w_bc``, ``A_log``, ``D``) are read at the rank's
channels, so their gradients are summed (:func:`~.layers._local`).  ``dt``
for the rank's channels contracts over every channel: the post-conv
activations are gathered along the channels, whose gradient, a part on
each rank, is summed (:func:`~repro_torch.core.spmd_pipeline.gather_seq`
on dim 2); B and C contract over the channels too, a partial product on
each rank summed in f32 and rounded once to the activation type, as a row
split's, and since each rank's scan reads them for its channels alone,
their gradient is summed as well.  ``out_proj`` is a row split
(:func:`~.layers._row_parallel`).  Under a data axis (and ``pod`` beside
it) the state holds the rank's rows of B over the batch's line, the
activations' rows (checked as it is read).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.spmd_pipeline import (all_reduce_sum, copy_to_ranks, gather_seq,
                                   local_bounds)
from .layers import (_MmF32, _cut, _dense_init, _enter, _local, _model_line,
                     _row_parallel, _state_rows)
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


def _ssm_core(p: Params, xc: torch.Tensor, h0: torch.Tensor,
              ch: slice | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """xc: [B, T, di] (post-conv, pre-activation). Returns (y, h_T).
    ``ch``: xc and h0 hold these channels only (this rank's; the module
    docstring), and so do y and h_T."""
    xc = F.silu(xc)
    if ch is None:
        dt = F.softplus(torch.einsum("btd,de->bte", xc, _local(p["w_dt"]))
                        .to(torch.float32) + _local(p["dt_bias"]))  # [B,T,di]
        bc = torch.einsum("btd,dcn->btcn", xc,
                          _local(p["w_bc"])).to(torch.float32)
        A_log, D = _local(p["A_log"]), _local(p["D"])
    else:
        line = _model_line(p["in_proj"])
        whole = gather_seq(xc.contiguous(), 2, *line)             # [B,T,di]
        w_dt = _cut(_local(p["w_dt"], True), 1, ch.start, ch.stop)
        dt = F.softplus(torch.einsum("btd,de->bte", whole, w_dt)
                        .to(torch.float32)
                        + _cut(_local(p["dt_bias"], True), 0, ch.start,
                               ch.stop))
        w_bc = _cut(_local(p["w_bc"], True), 0, ch.start, ch.stop)
        B, T, n = xc.shape
        part = _MmF32.apply(xc.reshape(B * T, n), w_bc.reshape(n, -1))
        # the sum's gradient, too, is a part on each rank (its channels')
        bc = copy_to_ranks(all_reduce_sum(part, *line), *line).to(
            xc.dtype).to(torch.float32).reshape(B, T, 2, -1)
        A_log = _cut(_local(p["A_log"], True), 0, ch.start, ch.stop)
        D = _cut(_local(p["D"], True), 0, ch.start, ch.stop)
    Bt, Ct = bc[:, :, 0], bc[:, :, 1]                             # [B,T,N]
    A = -torch.exp(A_log)                                         # [di,N]

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
    y = ys.transpose(0, 1) + D * xc.to(torch.float32)            # [B,T,di]
    return y, hT


def _state_local(leaf: torch.Tensor, dim: int, ch: slice, rows: int,
                 data) -> torch.Tensor:
    """This rank's part of a state leaf (a DTensor by ``cache_shardings``,
    or a plain tensor), which must hold channels ``ch`` along ``dim`` and
    the rows of B that x holds: ``rows`` of them, on the batch's data line
    ``data`` (:func:`~.layers._state_rows`)."""
    at = local_bounds(leaf)[dim]
    if (at.start, at.stop) != (ch.start, ch.stop):
        raise ValueError(f"the ssm state holds channels {at}, this rank "
                         f"computes {ch}")
    _state_rows(leaf, rows, data, "ssm state")
    return _local(leaf)


def ssm_apply(p: Params, x: torch.Tensor, state: Params | None = None, *,
              seq: bool = False, data=None) -> tuple[torch.Tensor, Params]:
    """Full-sequence (train/prefill), or decode from ``state``.
    x: [B,T,d] → (y [B,T,d], {"h": [B,d,N] f32, "conv": [B,K-1,d]}).

    Under DTensor weights (the module docstring) each rank runs its
    channels of ``in_proj``, and the new state holds them: the local
    tensors of ``state``'s shards.  ``seq``: ``x`` is this rank's part of
    the tokens (:class:`~.layers.SeqParallel`), gathered along S for the
    scan, and so is the output.  ``data``: x is this rank's rows of a
    batch split over that data line
    (:func:`~repro_torch.core.spmd_pipeline.batch_line`), as ``state``'s
    must be."""
    in_proj = p["in_proj"]
    di = in_proj.shape[2]
    ch = local_bounds(in_proj)[2]
    split = ch.stop - ch.start < di
    x = _enter(x, in_proj, split, seq)
    B, T, d = x.shape
    N = p["A_log"].shape[1]
    xz = torch.einsum("btd,dci->btci", x, _local(in_proj))
    xi, z = xz[:, :, 0], xz[:, :, 1]
    conv0 = h0 = None
    if state is not None:
        conv0 = _state_local(state["conv"], 2, ch, B, data)
        h0 = _state_local(state["h"], 1, ch, B, data)
    with record_function("ssm:conv"):
        xc = _causal_conv(xi, _cut(_local(p["conv"], split), 1, ch.start,
                                   ch.stop), conv0)
    if h0 is None:
        h0 = torch.zeros((B, ch.stop - ch.start, N), dtype=torch.float32,
                         device=x.device)
    y, hT = _ssm_core(p, xc, h0, ch if split else None)
    y = y.to(x.dtype) * F.silu(z)
    out = _row_parallel(y, p["out_proj"], seq)
    K = p["conv"].shape[0]
    if T >= K - 1:
        tail = xi[:, T - (K - 1):]
    elif state is not None:
        tail = torch.cat([conv0[:, T:], xi], dim=1)
    else:                   # the reference's zero tail (ROADMAP.md queue 3)
        tail = torch.zeros((B, K - 1, xi.shape[2]), dtype=x.dtype,
                           device=x.device)
    return out, {"h": hT, "conv": tail}


def ssm_init_state(batch: int, d: int, state: int, conv_k: int,
                   dtype: torch.dtype, device=None) -> Params:
    return {"h": torch.zeros((batch, d, state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_k - 1, d), dtype=dtype,
                                device=device)}
