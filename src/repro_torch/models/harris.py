"""The paper's case-study workload (Sect. IV): cornerHarris_Demo.

OpenCV processing flow on a 1920×1080 frame:

    cvtColor → cornerHarris → normalize → convertScaleAbs

The plain PyTorch "software" implementations are the database fallbacks
(the paper's "functions run on CPU"); ``repro_torch.kernels.harris``
registers the hand-written CUDA "hardware modules" for cvtColor /
cornerHarris / convertScaleAbs and the fused pair — and, as in the paper,
**normalize has no hardware module** and stays in software.

The functions mirror the OpenCV semantics used by the demo:
  * cvtColor: BT.601 RGB→gray
  * cornerHarris(blockSize=2, ksize=3, k=0.04): Sobel gradients, box-filtered
    second-moment matrix, response R = det(M) − k·trace(M)², with the
    image edge-padded once by the whole stencil reach
  * normalize: NORM_MINMAX to [0, 255], computed on the device (no host
    read-back of the min and max)
  * convertScaleAbs: |αx + β| saturated to [0, 255]
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.costmodel import (NodeCost, elementwise_cost, fused_cost,
                              stencil_cost)
from ..core.database import ModuleDatabase
from ..core.partition import stencil_tile_bytes
from ..core.placement import resolve_device
from ..kernels import harris as hk

# --------------------------------------------------------------------------- #
# software implementations (plain PyTorch; the kernels' plain versions)
# --------------------------------------------------------------------------- #
cvt_color = hk.cvt_color_ref
corner_harris = hk.corner_harris_ref
convert_scale_abs = hk.convert_scale_abs_ref


def normalize(x: torch.Tensor, alpha: float = 0.0,
              beta: float = 255.0) -> torch.Tensor:
    lo, hi = torch.amin(x), torch.amax(x)
    return (x - lo) / torch.clamp_min(hi - lo, 1e-12) * (beta - alpha) + alpha


# --------------------------------------------------------------------------- #
# the unmodified "binary" (paper Fig. 4 flow)
# --------------------------------------------------------------------------- #
def corner_harris_demo(lib):
    """Returns the demo app over an interposable Library — the user's code."""

    def app(img):
        gray = lib.cvtColor(img)
        resp = lib.cornerHarris(gray)
        norm = lib.normalize(resp)
        return lib.convertScaleAbs(norm)

    app.__name__ = "cornerHarris_Demo"
    return app


def make_frames(n: int, height: int, width: int, *, seed: int = 0,
                device=None) -> list[torch.Tensor]:
    """``n`` random RGB float32 frames in [0, 255), made from ``seed`` with
    numpy and moved to ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
                (rng.random((height, width, 3), dtype=np.float32) * 255)
            ).to(dev) for _ in range(n)]


# --------------------------------------------------------------------------- #
# database registration (cost providers = the synthesis-report analog)
# --------------------------------------------------------------------------- #
def _c_cvt(shapes, dtypes, params) -> NodeCost:
    h, w = shapes[0][:2]
    return elementwise_cost(h * w, flops_per_el=5, bytes_per_el=4, n_operands=4)


def _c_harris(shapes, dtypes, params) -> NodeCost:
    h, w = shapes[0][:2]
    return stencil_cost(h, w, 1, taps=6 * 2 + 4 * 3 + 8)   # sobel+box+response


def _c_norm(shapes, dtypes, params) -> NodeCost:
    h, w = shapes[0][:2]
    return elementwise_cost(h * w, flops_per_el=4, bytes_per_el=4, n_operands=3)


def _c_csa(shapes, dtypes, params) -> NodeCost:
    h, w = shapes[0][:2]
    return elementwise_cost(h * w, flops_per_el=4, bytes_per_el=4, n_operands=2)


def _fused_harris_smem(h: int, w: int, block_size: int = 2) -> int:
    """Shared memory one block of the fused kernel holds at the tile the
    autotuner picks for an ``h x w`` frame: its RGB source copies in flight
    and the gray tile they convert to (the epilogue adds none)."""
    th, tw = hk.fused_tile(h, w, block_size)
    return hk.tile_smem_bytes(th, tw, block_size, from_rgb=True)


def _c_fused_pair(shapes, dtypes, params) -> NodeCost:
    """Synthesis-report analog for the fused cvtColor+cornerHarris module:
    the gray intermediate stays in shared memory, its HBM write+read
    disappears."""
    h, w = shapes[0][:2]
    bs = (params or {}).get("block_size", 2)
    fe = fused_cost([_c_cvt(shapes, dtypes, params),
                     _c_harris([(h, w)], dtypes, params)],
                    intermediate_bytes=4 * h * w,
                    smem_required=_fused_harris_smem(h, w, bs))
    return fe.cost


def _c_fused_mega(shapes, dtypes, params) -> NodeCost:
    h, w = shapes[0][:2]
    bs = (params or {}).get("block_size", 2)
    fe = fused_cost([_c_cvt(shapes, dtypes, params),
                     _c_harris([(h, w)], dtypes, params),
                     _c_csa([(h, w)], dtypes, params)],
                    intermediate_bytes=2 * (4 * h * w),   # gray + response
                    smem_required=_fused_harris_smem(h, w, bs))
    return fe.cost


def make_harris_db(with_hw: bool = True) -> ModuleDatabase:
    """Build the module database for the case study.

    ``with_hw`` registers the CUDA modules for the three functions the
    paper had HLS modules for, plus the fused ones; ``normalize`` never gets
    one (paper Table I).
    """
    db = ModuleDatabase("harris")
    db.register("cvtColor", software=cvt_color, cost_hw=_c_cvt, cost_sw=_c_cvt)
    db.register("cornerHarris", software=corner_harris, cost_hw=_c_harris,
                cost_sw=_c_harris)
    db.register("normalize", software=normalize, cost_sw=_c_norm)  # sw-only!
    db.register("convertScaleAbs", software=convert_scale_abs, cost_hw=_c_csa,
                cost_sw=_c_csa)
    if with_hw:
        db.add_accelerated("cvtColor", hk.cvt_color)
        db.add_accelerated("cornerHarris", hk.corner_harris)
        db.add_accelerated("convertScaleAbs", hk.convert_scale_abs)
        # dedicated fused modules (single-pass kernels), resolved for fused
        # nodes when the cost model accepts the fusion.  In the demo chain
        # `normalize` (sw-only) sits between cornerHarris and
        # convertScaleAbs, so the fusable run is the pair; the 3-op module
        # serves normalize-free variants of the chain.
        db.register_fused(("cvtColor", "cornerHarris"),
                          hk.harris_fused_pair, cost_hw=_c_fused_pair,
                          smem_tile=stencil_tile_bytes)
        db.register_fused(("cvtColor", "cornerHarris", "convertScaleAbs"),
                          hk.harris_fused, cost_hw=_c_fused_mega,
                          smem_tile=stencil_tile_bytes)
    return db
