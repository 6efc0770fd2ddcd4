"""Flash attention forward — K7, the LM's attention "hardware module".

A CUDA kernel written by hand for Hopper (``csrc/flash_attention.cu``)
stands in for the JAX package's Pallas kernel
(``src/repro/kernels/flash_attention.py:_fwd``): online-softmax attention
of q ``[B, T, H, hd]`` against k, v ``[B, M, H, hd]`` (kv pre-expanded to
the H query heads), causal and/or sliding-window masked, f32 math, o in the
input type and an f32 log-sum-exp ``[B*H, T]``.

As in :mod:`repro_torch.kernels.rmsnorm`: a wrapper that checks its inputs,
allocates the outputs and launches on the current CUDA stream (raising if
the launch is refused); a plain PyTorch version, :func:`flash_attention_ref`,
in the reference's order of operations (``src/repro/kernels/ref.py:
reference_attention``), which the wrapper takes for a tensor on the CPU
and nowhere else; and a launch count in :data:`LAUNCHES`.

The masks are aligned at position 0 (query t sees key m when ``t - m >= 0``
if causal, and ``t - m < window`` if ``window > 0``), as in the TPU kernel.
The backward kernels (K8, K9) are not ported yet.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import check_input, launch

LAUNCHES: dict[str, int] = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's templated head_dims
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30                           # the reference's mask value


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    d = (torch.arange(T, device=q.device)[:, None]
         - torch.arange(M, device=q.device)[None, :])
    mask = torch.ones((T, M), dtype=torch.bool, device=q.device)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    s = torch.where(mask[None, None], s, torch.full((), NEG_INF,
                                                    device=q.device))
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, T)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtm,bmhd->bthd", p, v.to(torch.float32)).to(q.dtype)
    return o, lse


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
        lib._repro_typed = True
    return lib


def _check_kv(t: torch.Tensor, q: torch.Tensor, name: str) -> None:
    """k or v of a launch whose q lies on the card: same device and dtype,
    [B, M, H, hd] with q's B, H and hd, contiguous."""
    if not isinstance(t, torch.Tensor) or t.device != q.device:
        raise ValueError(f"flash_attention: {name} must be a tensor on "
                         f"{q.device}")
    if t.dtype != q.dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                        f"{q.dtype}")
    B, _, H, hd = q.shape
    if t.dim() != 4 or (t.shape[0], t.shape[2], t.shape[3]) != (B, H, hd):
        raise ValueError(f"flash_attention: expected {name} of [{B}, M, {H}, "
                         f"{hd}] (kv pre-expanded), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: the kernel takes a contiguous "
                         f"{name}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: (o, lse) of q [B, T, H, hd] against k/v [B, M, H, hd]; f32 or
    bf16, head_dim in :data:`HEAD_DIMS`; one block per (b*h, query tile)."""
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
        launch(LAUNCHES, "flash_attention", lib.repro_flash_attention_fwd,
               lib.repro_flash_attention_error_string, q,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), B, T, M, H, hd,
               int(q.dtype == torch.bfloat16), int(bool(causal)),
               int(window), 1.0 / math.sqrt(hd))
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, T, H, hd]; k/v [B, M, H, hd] (kv pre-expanded) → o
    [B, T, H, hd], the JAX entry's layout and defaults."""
    return flash_attention_fwd(q, k, v, causal, window)[0]
