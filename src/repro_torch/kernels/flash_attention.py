"""Flash attention — K7 (forward) and K8, K9 (backward), the LM's attention
"hardware module".

Hand-written CUDA kernels for Hopper stand in for the JAX package's Pallas
kernels (``src/repro/kernels/flash_attention.py``): K7
(``csrc/flash_attention.cu``, for ``_fwd``) computes online-softmax
attention of q ``[B, T, H, hd]`` against k, v ``[B, M, H, hd]`` (kv
pre-expanded to the H query heads), causal and/or sliding-window masked,
o in the input type and an f32 log-sum-exp ``[B*H, T]``.  Each kernel's
route is chosen by the input type, at every head_dim of :data:`HEAD_DIMS`:
bf16 runs on the tensor cores (K7 ``flash_fwd_wgmma_kernel``, K8
``flash_bwd_dq_wgmma_kernel``, K9 ``flash_bwd_dkv_wgmma_kernel``: wgmma
with bf16 operands and f32 sums, fed by TMA; p, and in the backward ds,
carried into their products as two bf16 terms), f32 on the SIMT kernels
(``flash_fwd_kernel``, ``flash_bwd_dq_kernel``, ``flash_bwd_dkv_kernel``,
f32 throughout), since the f32 limits (2e-5 of |o|, 2e-4 of |g|) leave no
room for bf16 or TF32 operands.  Neither route falls back to the other or
to the plain version; :data:`ROUTE_LAUNCHES` counts the launches of each.
K8 (dq) and K9 (dk, dv) (``csrc/flash_attention_bwd.cu``, for ``_bwd``)
recompute the probabilities from K7's lse, and take delta as rowsum(p *
(do . v)), the f32 o's rowsum with do (the JAX kernels read the stored o,
whose bf16 rounding moves the gradient by more than a bf16 ulp).
:class:`FlashAttention` binds them into one ``torch.autograd.Function``, so
:func:`flash_attention` is differentiable.

As in :mod:`repro_torch.kernels.rmsnorm`: wrappers that check their inputs,
allocate the outputs and launch on the current CUDA stream (raising if a
launch is refused); plain PyTorch versions, :func:`flash_attention_ref`
(the reference's order of operations, ``src/repro/kernels/ref.py:
reference_attention``) and :func:`flash_attention_bwd_ref` (the backward
kernels' recompute formulas), which the wrappers take for a tensor on the
CPU and nowhere else; and launch counts in :data:`ROUTE_LAUNCHES`, with
each kernel's total in :data:`LAUNCHES`.

The masks are aligned at position 0 (query t sees key m when ``t - m >= 0``
if causal, and ``t - m < window`` if ``window > 0``), as in the TPU kernel.
A query row that sees no key (only when ``window > 0`` and ``t >= M +
window - 1``) gets the reference's uniform softmax over its -1e30 scores in
the forward, and in the backward the gradient of that softmax: ``do / M``
to every dv row, nothing to dq or dk.  Its stored lse (-1e30 + log M
rounds to -1e30 in f32) cannot say so, so both backward versions find such
rows by their position (the JAX Pallas backward would give them p = 1).
"""
from __future__ import annotations

import ctypes
import math
from collections.abc import Mapping

import torch

from .build import check_input, launch

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's templated head_dims
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30                           # the reference's mask value
# each kernel's two routes, by input type (csrc/flash_attention.cu and
# csrc/flash_attention_bwd.cu): launches by kernel, then by route
ROUTES = {torch.bfloat16: "wgmma_bf16", torch.float32: "simt_f32"}
ROUTE_LAUNCHES: dict[str, dict[str, int]] = {
    k: {r: 0 for r in ROUTES.values()}
    for k in ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")}
# the f32 backward kernels' tiles (csrc/flash_attention_bwd.cu, Simt<HD>): a
# block owns SIMT_BWD_ROWS rows (K8 queries, K9 keys), the other side
# streams in tiles of simt_bwd_tile(hd) rows; staged rows take hd + 4
# floats, rows of the p / ds arrays tile + 4
SIMT_BWD_ROWS = 16


def simt_bwd_tile(hd: int) -> int:
    """Rows of the tiles the f32 K8 (keys) and K9 (queries) stream."""
    return 64 if hd <= 64 else 32 if hd == 128 else 16


def simt_bwd_smem_bytes(dkv: bool, hd: int, stages: int = 2) -> int:
    """Dynamic shared memory of an f32 K8 (K9 if ``dkv``) block: its own
    rows, ``stages`` tiles (K9's with their lse and delta), the p / ds
    arrays and K8's delta partials (4 warps)."""
    rows, bn, ld = SIMT_BWD_ROWS, simt_bwd_tile(hd), hd + 4
    return 4 * (2 * rows * ld + stages * (2 * bn * ld + (2 * bn if dkv else 0))
                + (2 if dkv else 1) * rows * (bn + 4) + (0 if dkv else 4 * rows))


# the f32 forward kernel's tiles (csrc/flash_attention.cu, Simt<HD>): a block
# owns SIMT_FWD_ROWS query rows, k and v stream in tiles of simt_fwd_tile(hd)
# rows from the block's first visible key
SIMT_FWD_ROWS = 16


def simt_fwd_tile(hd: int) -> int:
    """Rows of the k and v tiles the f32 K7 streams."""
    return 64 if hd <= 64 else 32 if hd == 128 else 16


def simt_fwd_smem_bytes(hd: int, stages: int = 2) -> int:
    """Dynamic shared memory of an f32 K7 block: its q rows, ``stages``
    tiles of k and v, the p array and the tile's row maxima (4 warps)."""
    rows, bn, ld = SIMT_FWD_ROWS, simt_fwd_tile(hd), hd + 4
    return 4 * (rows * ld + stages * 2 * bn * ld + rows * (bn + 4) + 4 * rows)


class _Totals(Mapping):
    """Each kernel's launches over both routes, read from
    :data:`ROUTE_LAUNCHES` (the one count kept)."""

    def __getitem__(self, name: str) -> int:
        return sum(ROUTE_LAUNCHES[name].values())

    def __iter__(self):
        return iter(ROUTE_LAUNCHES)

    def __len__(self) -> int:
        return len(ROUTE_LAUNCHES)


LAUNCHES: Mapping[str, int] = _Totals()


def reset_launches() -> None:
    for counts in ROUTE_LAUNCHES.values():
        for r in counts:
            counts[r] = 0


def _launch(name: str, fn, error_string, q: torch.Tensor, *args) -> None:
    """Launch one of the three kernels on ``q``'s device and count it on
    its route in :data:`ROUTE_LAUNCHES`."""
    launch(ROUTE_LAUNCHES, name, fn, error_string, q, *args,
           route=ROUTES[q.dtype])


# --------------------------------------------------------------------------- #
# the plain PyTorch version (the CPU path, and what the kernel is held to)
# --------------------------------------------------------------------------- #
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, T, H, hd], k/v [B, M, H, hd] → (o [B, T, H, hd] in q's dtype,
    lse [B*H, T] f32): exact softmax over the masked f32 scores."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    s = torch.einsum("bthd,bmhd->bhtm", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    mask = visible(T, M, causal, window, q.device)
    s = torch.where(mask[None, None], s, torch.full((), NEG_INF,
                                                    device=q.device))
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, T)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtm,bmhd->bthd", p, v.to(torch.float32)).to(q.dtype)
    return o, lse


def visible(T: int, M: int, causal: bool, window: int,
            device=None) -> torch.Tensor:
    """[T, M] bool: query t sees key m."""
    d = (torch.arange(T, device=device)[:, None]
         - torch.arange(M, device=device)[None, :])
    mask = torch.ones((T, M), dtype=torch.bool, device=device)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    return mask


def _recompute(q, k, v, do, lse, causal: bool, window: int):
    """The f32 operands and the recomputed [B, H, T, M] p = exp(s - lse)
    (0 where not visible) and dp = do . v of the backward formulas."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    qf, kf, vf, dof = (t.to(torch.float32) for t in (q, k, v, do))
    mask = visible(T, M, causal, window, q.device)[None, None]
    s = torch.einsum("bthd,bmhd->bhtm", qf, kf) * (1.0 / math.sqrt(hd))
    p = torch.where(mask, torch.exp(s - lse.reshape(B, H, T, 1)),
                    torch.zeros((), device=q.device))
    del s
    dp = torch.einsum("bthd,bmhd->bhtm", dof, vf)
    return qf, kf, dof, mask, p, dp


def flash_attention_bwd_dq_ref(q, k, v, lse, do, causal: bool = True,
                               window: int = 0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8's formulas in f32 over the whole [T, M] at once: delta =
    rowsum(p * dp), ds = p * (dp - delta), dq = ds k / sqrt(hd).  Returns
    (dq in q's dtype, f32 delta [B*H, T]).  Rows that see no key have p = 0
    here, so ds = 0 and dq = 0 (see the module's docstring)."""
    B, T, H, hd = q.shape
    _, kf, _, mask, p, dp = _recompute(q, k, v, do, lse, causal, window)
    delta = (p * dp).sum(-1)
    ds = torch.where(mask, p * (dp - delta[..., None]),
                     torch.zeros((), device=q.device))
    dq = torch.einsum("bhtm,bmhd->bthd", ds, kf) * (1.0 / math.sqrt(hd))
    return dq.to(q.dtype), delta.reshape(B * H, T)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = True,
                                window: int = 0
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's formulas from K8's delta: dk = ds^T q / sqrt(hd), dv = p^T do,
    in the inputs' dtypes.  Rows that see no key give ds = 0 and p = 1/M
    to dv (see the module's docstring)."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    qf, _, dof, mask, p, dp = _recompute(q, k, v, do, lse, causal, window)
    ds = torch.where(mask, p * (dp - delta.reshape(B, H, T, 1)),
                     torch.zeros((), device=q.device))
    del dp
    dk = torch.einsum("bhtm,bthd->bmhd", ds, qf) * (1.0 / math.sqrt(hd))
    del ds
    blind = ~mask.any(dim=-1, keepdim=True)               # [1, 1, T, 1]
    p = torch.where(blind, torch.full((), 1.0 / M, device=q.device), p)
    dv = torch.einsum("bhtm,bthd->bmhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, lse, do, causal: bool = True,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) in the input type, by the backward kernels' recompute
    formulas: :func:`flash_attention_bwd_dq_ref` then
    :func:`flash_attention_bwd_dkv_ref`."""
    dq, delta = flash_attention_bwd_dq_ref(q, k, v, lse, do, causal, window)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                         window)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# the CUDA library and the wrappers
# --------------------------------------------------------------------------- #
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def library() -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` built and loaded (at first use), with
    every function's argument types declared."""
    from .build import load

    lib = load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        lib.repro_flash_attention_fwd.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
        lib.repro_flash_attention_fwd.restype = ctypes.c_int
        lib.repro_flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.repro_flash_attention_error_string.restype = ctypes.c_char_p
        lib.repro_flash_attention_smem_bytes.argtypes = [_I, _I]
        lib.repro_flash_attention_smem_bytes.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def bwd_library() -> ctypes.CDLL:
    """``csrc/flash_attention_bwd.cu`` (K8, K9) built and loaded."""
    from .build import load

    lib = load("flash_attention_bwd")
    if not getattr(lib, "_repro_typed", False):
        for fn, n_ptr in ((lib.repro_flash_attention_bwd_dq, 7),
                          (lib.repro_flash_attention_bwd_dkv, 8)):
            fn.argtypes = [_P] * n_ptr + [_I] * 8 + [_F, _P]
            fn.restype = ctypes.c_int
        lib.repro_flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.repro_flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib.repro_flash_attention_bwd_smem_bytes.argtypes = [_I, _I, _I]
        lib.repro_flash_attention_bwd_smem_bytes.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_kv(t: torch.Tensor, q: torch.Tensor, name: str,
              rows: int | None = None) -> None:
    """k, v (or o, do) of a launch whose q lies on the card: same device
    and dtype, [B, rows, H, hd] with q's B, H and hd (any rows when
    ``rows`` is None), contiguous."""
    if not isinstance(t, torch.Tensor) or t.device != q.device:
        raise ValueError(f"flash_attention: {name} must be a tensor on "
                         f"{q.device}")
    if t.dtype != q.dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                        f"{q.dtype}")
    B, _, H, hd = q.shape
    if (t.dim() != 4 or (t.shape[0], t.shape[2], t.shape[3]) != (B, H, hd)
            or rows not in (None, t.shape[1])):
        raise ValueError(f"flash_attention: expected {name} of [{B}, "
                         f"{'M' if rows is None else rows}, {H}, {hd}] (kv "
                         f"pre-expanded), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: the kernel takes a contiguous "
                         f"{name}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: (o, lse) of q [B, T, H, hd] against k/v [B, M, H, hd]; f32 or
    bf16, head_dim in :data:`HEAD_DIMS`; one block per (b*h, query tile:
    128 rows in bf16, :data:`SIMT_FWD_ROWS` in f32), on the route
    :data:`ROUTES` names for the type."""
    if not check_input(q, "flash_attention", lambda s: len(s) == 4,
                       "q of [B, T, H, hd]", dtypes=DTYPES):
        return flash_attention_ref(q, k, v, causal, window)
    _check_kv(k, q, "k")
    _check_kv(v, q, "v")
    B, T, H, hd = q.shape
    M = k.shape[1]
    if v.shape[1] != M:
        raise ValueError(f"flash_attention: k has {M} rows, v {v.shape[1]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} is not one the "
                         f"kernel takes {HEAD_DIMS}")
    if M == 0 and T:
        raise ValueError("flash_attention: no keys to attend to (M == 0)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes 16-byte aligned "
                         "q, k and v")
    o = torch.empty_like(q)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    if B and T and H:
        if B * H > 65535 or max(T, M) >= 2**31:
            raise ValueError(f"flash_attention: [{B}, {T}, {H}, {hd}] "
                             f"exceeds the kernel's grid")
        lib = library()
        _launch("flash_attention", lib.repro_flash_attention_fwd,
                lib.repro_flash_attention_error_string, q,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, T, M, H, hd,
                int(q.dtype == torch.bfloat16), int(bool(causal)),
                int(window), 1.0 / math.sqrt(hd))
    return o, lse


def _check_bwd(q, k, v, rows: dict, stats: dict) -> tuple[int, ...]:
    """Validate a backward launch whose q lies on the card: ``rows`` are
    [B, T, H, hd] like q (o, do), ``stats`` f32 [B*H, T] (lse, delta).
    Returns (B, T, M, H, hd)."""
    what = "flash_attention_bwd"
    _check_kv(k, q, "k")
    M = k.shape[1]
    _check_kv(v, q, "v", M)
    B, T, H, hd = q.shape
    for name, t in rows.items():
        _check_kv(t, q, name, T)
    for name, t in stats.items():
        if (not isinstance(t, torch.Tensor) or t.device != q.device
                or t.dtype != torch.float32 or tuple(t.shape) != (B * H, T)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: expected a contiguous f32 {name} of "
                             f"[{B * H}, {T}] on {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} is not one the kernels take "
                         f"{HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v, *rows.values())):
        raise ValueError(f"{what}: the kernels take 16-byte aligned tensors")
    if B * H > 65535 or max(T, M) >= 2**31:
        raise ValueError(f"{what}: [{B}, {T}, {H}, {hd}] exceeds the "
                         f"kernels' grid")
    return B, T, M, H, hd


def _bwd_shape(q, dims, causal, window) -> tuple:
    B, T, M, H, hd = dims
    return (B, T, M, H, hd, int(q.dtype == torch.bfloat16), int(bool(causal)),
            int(window), 1.0 / math.sqrt(hd))


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor,
                           causal: bool = True, window: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8: (dq, delta) — dq of o = attention(q, k, v) for the output's
    gradient ``do`` (contiguous; :func:`flash_attention_bwd` makes it so),
    and the f32 delta = rowsum(p * (do . v)) [B*H, T] that K9 takes; on
    the route :data:`ROUTES` names for the type."""
    if not check_input(q, "flash_attention_bwd", lambda s: len(s) == 4,
                       "q of [B, T, H, hd]", dtypes=DTYPES):
        return flash_attention_bwd_dq_ref(q, k, v, lse, do, causal, window)
    dims = _check_bwd(q, k, v, {"do": do}, {"lse": lse})
    B, T, _, H, _ = dims
    dq = torch.empty_like(q)
    delta = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    if 0 in dims:
        return dq.zero_(), delta.zero_()
    lib = bwd_library()
    _launch("flash_attention_bwd_dq", lib.repro_flash_attention_bwd_dq,
            lib.repro_flash_attention_bwd_error_string, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            *_bwd_shape(q, dims, causal, window))
    return dq, delta


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True, window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9: (dk, dv), from K8's delta."""
    if not check_input(q, "flash_attention_bwd", lambda s: len(s) == 4,
                       "q of [B, T, H, hd]", dtypes=DTYPES):
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           window)
    dims = _check_bwd(q, k, v, {"do": do}, {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if 0 in dims:
        return dk.zero_(), dv.zero_()
    lib = bwd_library()
    _launch("flash_attention_bwd_dkv", lib.repro_flash_attention_bwd_dkv,
            lib.repro_flash_attention_bwd_error_string, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_shape(q, dims, causal, window))
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 then K9: (dq, dk, dv) of o = attention(q, k, v) for the output's
    gradient ``do``, from the forward's lse (:func:`flash_attention_fwd`);
    on the CPU, :func:`flash_attention_bwd_ref`.  The forward's o is not
    read: delta comes from p and do . v (``csrc/flash_attention_bwd.cu``)."""
    if not check_input(q, "flash_attention_bwd", lambda s: len(s) == 4,
                       "q of [B, T, H, hd]", dtypes=DTYPES):
        return flash_attention_bwd_ref(q, k, v, lse, do, causal, window)
    do = do.contiguous()          # autograd may hand over a strided gradient
    dq, delta = flash_attention_bwd_dq(q, k, v, lse, do, causal, window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v): forward K7, saving (q, k, v, lse); backward
    K8 and K9.  On CPU tensors, the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, ctx.causal,
                                         ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, T, H, hd]; k/v [B, M, H, hd] (kv pre-expanded) → o
    [B, T, H, hd], the JAX entry's layout and defaults; differentiable."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window))
