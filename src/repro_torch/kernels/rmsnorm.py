"""RMSNorm kernels — the transformer-side "hardware modules".

Two CUDA kernels, written by hand for Hopper in ``csrc/rmsnorm.cu``, stand
in for the JAX package's Pallas kernels (``src/repro/kernels/rmsnorm.py``):

* K5 :func:`rmsnorm` — ``x * rsqrt(mean(x²) + eps) * (1 + scale)``, f32 math;
* K6 :func:`rmsnorm_matmul` — ``rmsnorm(x, scale) @ w`` with f32
  accumulation, the normalised rows never written to HBM; its products run
  on the tensor cores (:data:`GEMM_ROUTE`: ``wgmma`` with each f32 operand
  split into two TF32 terms, three products summed in f32), at every shape.

Each has, as in :mod:`repro_torch.kernels.harris`, a wrapper that checks
its inputs, allocates the output and launches on the current CUDA stream
(raising if the launch is refused); a plain PyTorch version (``*_ref``) in
the reference's order of operations, which the wrapper takes for a tensor
on the CPU and nowhere else; and a launch count in :data:`LAUNCHES`.

The wrappers flatten leading dims to rows, as the JAX package's
``kernels/ops.py`` does, so a micro-batched group ``[B, T, d]`` is one
launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .build import check_input, launch

LAUNCHES: dict[str, int] = {"rmsnorm": 0, "rmsnorm_matmul": 0}

EPS = 1e-6
# K6's block tile (BM, BN, BK in rmsnorm.cu): output rows x output columns
# x the k slice of a step; the ring of w's hi and lo TF32 terms
# (kBStages) and the raw ring of x, w and s (kRawStages), two barriers a
# stage each
GEMM_TILE = (128, 128, 32)
GEMM_B_STAGES = 3
GEMM_RAW_STAGES = 3
# K6's one route: 3xTF32 on wgmma, for every shape (16- or 4-byte copies by
# alignment inside the kernel)
GEMM_ROUTE = "wgmma_tf32x3"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path, and what the kernels are held to)
# --------------------------------------------------------------------------- #
def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = EPS) -> torch.Tensor:
    """x: [..., d], scale: [d] — the reference's ``reference_rmsnorm``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rmsnorm_matmul_ref(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                       eps: float = EPS) -> torch.Tensor:
    """rmsnorm then matmul, f32 accumulation; x: [..., d], w: [d, out]."""
    y = rmsnorm_ref(x, scale, eps).to(torch.float32)
    return torch.matmul(y, w.to(torch.float32)).to(x.dtype)


def gemm_smem_bytes() -> int:
    """Shared memory one K6 block holds (the same sum as
    ``repro_rmsnorm_matmul_smem_bytes`` in rmsnorm.cu): the ring of w's
    hi and lo TF32 terms over a BK slice of BN columns, the raw ring (a BK
    slice of BM rows of x, of BN columns of w, and of the scale), 8 bytes a
    barrier, and 1 KB to align the swizzled tiles."""
    bm, bn, bk = GEMM_TILE
    bs, raw = GEMM_B_STAGES, GEMM_RAW_STAGES
    return (4 * (bs * 2 * bn * bk + raw * (bm * bk + bk * bn + bk))
            + 8 * 2 * (bs + raw) + 1024)


def gemm_tile_bytes(ir, value_names) -> int:
    """K6's tile for the fusion gate: one block's shared memory, the same
    whatever the widths of the values the fused run touches."""
    del ir, value_names
    return gemm_smem_bytes()


# --------------------------------------------------------------------------- #
# the CUDA library and the wrappers
# --------------------------------------------------------------------------- #
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "repro_rmsnorm_f32": (_P, _P, _P, _I64, _I, _F, _P),
    "repro_rmsnorm_matmul_f32": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
}


def library() -> ctypes.CDLL:
    """``csrc/rmsnorm.cu`` built and loaded (at first use), with every
    function's argument types declared."""
    from .build import load

    lib = load("rmsnorm")
    if not getattr(lib, "_repro_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.repro_rmsnorm_matmul_smem_bytes.argtypes = []
        lib.repro_rmsnorm_matmul_smem_bytes.restype = ctypes.c_int64
        lib.repro_rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.repro_rmsnorm_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    launch(LAUNCHES, name, fn, library().repro_rmsnorm_error_string, x,
           *args)


def _check_operand(t: torch.Tensor, x: torch.Tensor, name: str, what: str,
                   shape: tuple) -> None:
    """A side operand of a kernel whose activation ``x`` lies on the card:
    same device, float32, the expected shape, contiguous."""
    if not isinstance(t, torch.Tensor) or t.device != x.device:
        raise ValueError(f"{name}: {what} must be a tensor on {x.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes a float32 {what}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {what} of shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous {what}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = EPS) -> torch.Tensor:
    """K5: rmsnorm of x [..., d] f32 with scale [d]; one row a block."""
    if not check_input(x, "rmsnorm", lambda s: len(s) >= 1, "[..., d]"):
        return rmsnorm_ref(x, scale, eps)
    d = x.shape[-1]
    _check_operand(scale, x, "rmsnorm", "scale", (d,))
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        _launch("rmsnorm", library().repro_rmsnorm_f32, x, x.data_ptr(),
                scale.data_ptr(), out.data_ptr(), rows, d, float(eps))
    return out


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   eps: float = EPS) -> torch.Tensor:
    """K6: fused ``rmsnorm(x, scale) @ w``; x [..., d], scale [d],
    w [d, out] f32 → [..., out], on the tensor cores (3xTF32)."""
    if not check_input(x, "rmsnorm_matmul", lambda s: len(s) >= 1,
                       "[..., d]"):
        return rmsnorm_matmul_ref(x, scale, w, eps)
    d = x.shape[-1]
    _check_operand(scale, x, "rmsnorm_matmul", "scale", (d,))
    if not isinstance(w, torch.Tensor) or w.dim() != 2:
        raise ValueError("rmsnorm_matmul: w must be a [d, out] tensor")
    dout = w.shape[1]
    _check_operand(w, x, "rmsnorm_matmul", "w", (d, dout))
    rows = x.numel() // d if d else 0
    out = torch.empty((*x.shape[:-1], dout), dtype=torch.float32,
                      device=x.device)
    if rows and dout and d:
        blocks = (math.ceil(rows / GEMM_TILE[0])
                  * math.ceil(dout / GEMM_TILE[1]))
        if max(rows, dout, d, blocks) >= 2**31:
            raise ValueError(f"rmsnorm_matmul: [{rows}, {d}] @ [{d}, {dout}] "
                             f"exceeds the kernel's grid")
        _launch("rmsnorm_matmul", library().repro_rmsnorm_matmul_f32, x,
                x.data_ptr(), scale.data_ptr(), w.data_ptr(), out.data_ptr(),
                rows, dout, d, float(eps))
    elif rows and dout:
        out.zero_()                         # an empty sum
    return out
