"""Public kernel entry points and the rmsnorm/matmul database rows.

The JAX package's ``kernels/ops.py`` wraps each Pallas kernel in a ``jit``
and a global switch (``use_kernels``) that picks the kernel or its jnp
reference.  Here the switch is the tensor's device, inside each wrapper: a
CUDA tensor launches the hand-written kernel (or raises), a CPU tensor takes
the plain PyTorch version.  So the entry points below are the wrappers
themselves, and there is no switch to set.

``attention`` is the flash-attention forward (K7), the route the LM's
self-attention takes (``models/layers.py:attention``).
"""
from __future__ import annotations

import torch

from ..core.costmodel import (NodeCost, elementwise_cost, fused_cost,
                              matmul_cost)
from .flash_attention import flash_attention as attention
from .harris import convert_scale_abs, corner_harris, cvt_color, harris_fused
from .rmsnorm import (gemm_smem_bytes, gemm_tile_bytes, rmsnorm,
                      rmsnorm_matmul, rmsnorm_ref)

__all__ = ["attention", "rmsnorm", "rmsnorm_matmul", "cvt_color",
           "corner_harris", "convert_scale_abs", "harris_response",
           "register_rmsnorm_matmul_modules"]


def harris_response(img: torch.Tensor, block_size: int = 2, k: float = 0.04,
                    alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """Single-call fused Harris chain (cvt → harris → csa), K4."""
    return harris_fused(img, block_size, k, alpha, beta)


# --------------------------------------------------------------------------- #
# Database registration — the rmsnorm/matmul module family
# --------------------------------------------------------------------------- #
def _c_rms(shapes, dtypes, params) -> NodeCost:
    n, d = shapes[0]
    return elementwise_cost(n * d, flops_per_el=4, bytes_per_el=4,
                            n_operands=2)


def _c_mm(shapes, dtypes, params) -> NodeCost:
    (n, d), (_, dout) = shapes[0], shapes[1]
    return matmul_cost(n, dout, d, bytes_per_el=4)


def _c_fused(shapes, dtypes, params) -> NodeCost:
    n, d = shapes[0]
    dout = shapes[2][1] if len(shapes) > 2 else d
    inter = 4 * n * d                 # the normalized [n, d] intermediate
    fe = fused_cost([_c_rms([(n, d)], None, None),
                     _c_mm([(n, d), (d, dout)], None, None)],
                    intermediate_bytes=inter,
                    smem_required=gemm_smem_bytes())
    return fe.cost


def _sw_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def register_rmsnorm_matmul_modules(db) -> None:
    """Register rmsnorm / matmul (+ the fused pair) into a ModuleDatabase.

    The ``rmsnorm`` hw row is K5 and the fused ``("rmsnorm", "matmul")``
    row is K6.  The ``matmul`` row's accelerated module is the plain
    ``torch.matmul`` (cuBLAS on the card): the JAX row is ``jnp.dot`` outside
    any Pallas kernel, left to XLA.  Every row takes leading batch dims, so
    the executor hands a micro-batched group to them in one call.
    """
    db.register("rmsnorm", software=rmsnorm_ref, accelerated=rmsnorm,
                applicable=lambda *s: len(s[0]) == 2,
                cost_hw=_c_rms, cost_sw=_c_rms, batch_dims=True)
    db.register("matmul", software=_sw_mm, accelerated=_sw_mm,
                cost_hw=_c_mm, cost_sw=_c_mm, batch_dims=True)
    db.register_fused(("rmsnorm", "matmul"), accelerated=rmsnorm_matmul,
                      applicable=lambda *s: len(s[0]) == 2,
                      cost_hw=_c_fused, smem_tile=gemm_tile_bytes,
                      batch_dims=True)
