"""Harris case-study kernels — the predefined "hardware modules" (paper §IV).

Four CUDA kernels, written by hand for Hopper in ``csrc/harris.cu``, mirror
the HLS modules the paper's database held (``hls::cvtColor``,
``hls::cornerHarris``, ``hls::convertScaleAbs``) plus the single-pass fused
module; ``normalize`` deliberately has none, exactly like the paper's
Table I.

Each kernel has, in this module:

* a wrapper (``cvt_color``, ``corner_harris``, ``convert_scale_abs``,
  ``harris_fused``) that checks its input, allocates the output, launches
  on the current CUDA stream and raises if the launch is refused.  A tensor
  on the CPU goes to the plain version instead; a CUDA tensor launches the
  kernel or raises — nothing falls back;
* a plain PyTorch version (``*_ref``) of the same function, in the
  reference's order of operations;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

Border convention (the JAX package's pad-once scheme): the image is
edge-padded by ``halo = 1 + block_size // 2`` (``halo + block_size - 1`` at
the bottom and right), padded coordinate ``p`` maps to original
``clamp(p - halo, 0, n - 1)``, and Sobel and the box filter then run
"valid".
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..core.costmodel import H100, DeviceClass, MAX_THREADS_PER_SM
from .autotune import AutotuneCache, autotune, device_key
from .build import check_input, launch

LAUNCHES: dict[str, int] = {"cvt_color": 0, "corner_harris": 0,
                            "convert_scale_abs": 0, "harris_fused": 0}

# K2/K4's block geometry (the constants of the same names in harris.cu)
TILE_THREADS = 128               # threads a block (kTileThreads)
MICRO_TILE = (2, 4)              # one thread's outputs, rows x cols (kMY, kMX)
HALO = 2                         # 1 + block_size // 2 for block_size 2 and 3
PAD_X = 4                        # source columns copied beside a tile (kPadX)
INFLIGHT_BYTES = 18 * 1024       # an SM's share of 3.35 TB/s x ~700 ns
TILE_CANDIDATES = ((8, 32), (16, 32), (16, 64), (32, 32), (32, 64),
                   (64, 64), (64, 128), (128, 128))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path, and what the kernels are held to)
# --------------------------------------------------------------------------- #
def cvt_color_ref(img: torch.Tensor) -> torch.Tensor:
    """RGB [H, W, 3] → gray [H, W] float32 (BT.601)."""
    img = img.to(torch.float32)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _edge_pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Edge-replicating pad of a [H, W] image: padded coordinate p holds
    original clamp(p - before, 0, n - 1)."""
    return F.pad(x[None, None], (before, after, before, after),
                 mode="replicate")[0, 0]


def corner_harris_ref(gray: torch.Tensor, block_size: int = 2,
                      k: float = 0.04) -> torch.Tensor:
    """Sobel gradients → box-filtered second moments → Harris response.

    The image is edge-padded ONCE by the full stencil reach (sobel + box),
    and both stages then run "valid".
    """
    H, W = gray.shape
    halo = 1 + block_size // 2
    g = _edge_pad(gray.to(torch.float32), halo, halo + block_size - 1)
    h1, w1 = H + 2 * halo - 2, W + 2 * halo - 2

    def sh(dy, dx):
        return g[dy:dy + h1, dx:dx + w1]

    dx = (sh(0, 2) + 2 * sh(1, 2) + sh(2, 2)
          - sh(0, 0) - 2 * sh(1, 0) - sh(2, 0))
    dy = (sh(2, 0) + 2 * sh(2, 1) + sh(2, 2)
          - sh(0, 0) - 2 * sh(0, 1) - sh(0, 2))
    ixx, iyy, ixy = dx * dx, dy * dy, dx * dy

    def box(a):
        out = torch.zeros((H, W), dtype=torch.float32, device=gray.device)
        for by in range(block_size):
            for bx in range(block_size):
                out = out + a[by:by + H, bx:bx + W]
        return out

    sxx, syy, sxy = box(ixx), box(iyy), box(ixy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def convert_scale_abs_ref(x: torch.Tensor, alpha: float = 1.0,
                          beta: float = 0.0) -> torch.Tensor:
    return torch.clamp(torch.abs(x * alpha + beta), 0.0, 255.0)


def harris_fused_ref(img: torch.Tensor, block_size: int = 2, k: float = 0.04,
                     alpha: float = 1.0, beta: float = 0.0, *,
                     with_csa: bool = True) -> torch.Tensor:
    resp = corner_harris_ref(cvt_color_ref(img), block_size, k)
    return convert_scale_abs_ref(resp, alpha, beta) if with_csa else resp


# --------------------------------------------------------------------------- #
# tile choice for the stencil kernels
# --------------------------------------------------------------------------- #
def tile_ok(th: int, tw: int) -> bool:
    """A tile K2/K4 take (``tile_ok`` in harris.cu): whole micro-tiles, and
    micro-tile columns that divide the block's threads."""
    my, mx = MICRO_TILE
    return (th >= my and tw >= mx and th % my == 0 and tw % mx == 0
            and tw // mx <= TILE_THREADS and TILE_THREADS % (tw // mx) == 0)


def tile_smem_bytes(th: int, tw: int, block_size: int,
                    from_rgb: bool = False) -> int:
    """Shared memory one K2 (gray) or K4 (``from_rgb``) block holds for a
    ``th x tw`` output tile: the tile's source, (th + block_size + 1) rows of
    tw + 2 * PAD_X pixels, 3 floats a pixel for K4, plus K4's converted gray
    tile (the same sum as ``tile_smem_bytes`` in harris.cu)."""
    px = (th + block_size + 1) * (tw + 2 * PAD_X)
    return 4 * px * (4 if from_rgb else 1)


def _device_class(device) -> DeviceClass:
    """H100 priors, with the SM count and shared-memory limits read from the
    card when the tile is tuned for a CUDA device."""
    if device is None or torch.device(device).type != "cuda":
        return H100
    p = torch.cuda.get_device_properties(torch.device(device))
    return DeviceClass(
        "cuda", sm_count=p.multi_processor_count,
        smem_bytes=getattr(p, "shared_memory_per_block_optin", H100.smem_bytes),
        smem_per_sm=getattr(p, "shared_memory_per_multiprocessor",
                            H100.smem_per_sm))


def tile_score(tile: tuple[int, int], H: int, W: int, block_size: int,
               dev: DeviceClass = H100) -> float:
    """Lower-is-better analytic score of a K2/K4 tile (the TPU kernels'
    ``_roofline_rb_score`` with shared memory in place of VMEM).

    The bytes a tile copies per output byte (its halo and the 16-byte
    aligned columns beside it), divided by three shares: the share of the
    block's threads that own a micro-tile; the share of the grid's block
    slots that are busy (one block a tile; blocks resident per SM are
    limited by K2's shared memory and by threads, not by registers, which
    are known only once the kernel is built; a grid that ends in a
    part-empty wave leaves SMs idle); and the bytes the resident blocks keep
    in flight (a tile each) against the ``INFLIGHT_BYTES`` an SM needs to
    cover HBM's latency.  A tile the
    kernel does not take, or one whose K4 layout (the larger) is over the
    per-block shared memory limit, is infeasible.
    """
    th, tw = tile
    smem = tile_smem_bytes(th, tw, block_size)
    if not tile_ok(th, tw) or tile_smem_bytes(th, tw, block_size,
                                              True) > dev.smem_bytes:
        return float("inf")
    copied = (th + block_size + 1) * (tw + 2 * PAD_X)
    amp = copied / (th * tw)
    my, mx = MICRO_TILE
    util = min(1.0, (th // my) * (tw // mx) / TILE_THREADS)
    per_sm = max(1, min(dev.smem_per_sm // smem,
                        MAX_THREADS_PER_SM // TILE_THREADS))
    n_tiles = math.ceil(H / th) * math.ceil(W / tw)
    slots = dev.sm_count * per_sm
    busy = n_tiles / (math.ceil(n_tiles / slots) * slots)
    inflight = min(1.0, per_sm * 4 * copied / INFLIGHT_BYTES)
    return amp / (util * busy * inflight)


def fused_tile(H: int, W: int, block_size: int = 2, *, device=None,
               cache: AutotuneCache | None = None) -> tuple[int, int]:
    """Autotuned output tile (rows, cols) for :func:`corner_harris` and
    :func:`harris_fused` on ``device`` (default: the H100 priors),
    memoised on disk under the card's name and compute capability."""
    dev = _device_class(device)
    res = autotune("harris_tile",
                   (H, W, "float32", block_size, TILE_THREADS, *MICRO_TILE,
                    *device_key(device)),
                   [list(t) for t in TILE_CANDIDATES],
                   lambda t: tile_score(tuple(t), H, W, block_size, dev),
                   cache=cache)
    return int(res.best[0]), int(res.best[1])


# --------------------------------------------------------------------------- #
# the CUDA library and the wrappers
# --------------------------------------------------------------------------- #
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "repro_cvt_color_f32": (_P, _P, _I64, _P),
    "repro_convert_scale_abs_f32": (_P, _P, _I64, _F, _F, _P),
    "repro_corner_harris_f32": (_P, _P, _I, _I, _I, _F, _I, _I, _P),
    "repro_harris_fused_f32": (_P, _P, _I, _I, _I, _F, _I, _F, _F, _I, _I, _P),
    "repro_harris_tile_smem_bytes": (_I, _I, _I, _I),
}


def library() -> ctypes.CDLL:
    """``csrc/harris.cu`` built and loaded (at first use), with every
    function's argument types declared."""
    from .build import load

    lib = load("harris")
    if not getattr(lib, "_repro_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.repro_harris_tile_smem_bytes.restype = ctypes.c_int64
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    launch(LAUNCHES, name, fn, library().repro_cuda_error_string, x, *args)


def _block_size_ok(name: str, block_size: int) -> None:
    if block_size not in (2, 3):
        raise ValueError(f"{name}: the kernel takes block_size 2 or 3, "
                         f"got {block_size}")


def _tile_ok(name: str, tile: tuple[int, int]) -> tuple[int, int]:
    if not tile_ok(*tile):
        raise ValueError(f"{name}: the kernel takes a tile of whole "
                         f"{MICRO_TILE[0]}x{MICRO_TILE[1]} micro-tiles whose "
                         f"columns divide {TILE_THREADS} threads, got {tile}")
    return tile


def cvt_color(img: torch.Tensor) -> torch.Tensor:
    """K1: RGB [H, W, 3] f32 → gray [H, W] f32."""
    if not check_input(img, "cvt_color",
                       lambda s: len(s) == 3 and s[2] == 3, "[H, W, 3]"):
        return cvt_color_ref(img)
    H, W, _ = img.shape
    out = torch.empty((H, W), dtype=torch.float32, device=img.device)
    if out.numel():
        _launch("cvt_color", library().repro_cvt_color_f32, img,
                img.data_ptr(), out.data_ptr(), H * W)
    return out


def convert_scale_abs(x: torch.Tensor, alpha: float = 1.0,
                      beta: float = 0.0) -> torch.Tensor:
    """K3: clip(|alpha * x + beta|, 0, 255), f32."""
    if not check_input(x, "convert_scale_abs", lambda s: True, "any shape"):
        return convert_scale_abs_ref(x, alpha, beta)
    out = torch.empty_like(x)
    if out.numel():
        _launch("convert_scale_abs", library().repro_convert_scale_abs_f32, x,
                x.data_ptr(), out.data_ptr(), x.numel(), float(alpha),
                float(beta))
    return out


def corner_harris(gray: torch.Tensor, block_size: int = 2, k: float = 0.04, *,
                  tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K2: Harris response of a gray [H, W] f32 image; ``tile`` defaults to
    the autotuned :func:`fused_tile`."""
    if not check_input(gray, "corner_harris", lambda s: len(s) == 2,
                       "[H, W]"):
        return corner_harris_ref(gray, block_size, k)
    _block_size_ok("corner_harris", block_size)
    H, W = gray.shape
    out = torch.empty((H, W), dtype=torch.float32, device=gray.device)
    if out.numel():
        th, tw = _tile_ok("corner_harris", tile or fused_tile(
            H, W, block_size, device=gray.device))
        _launch("corner_harris", library().repro_corner_harris_f32, gray,
                gray.data_ptr(), out.data_ptr(), H, W, block_size, float(k),
                th, tw)
    return out


def harris_fused(img: torch.Tensor, block_size: int = 2, k: float = 0.04,
                 alpha: float = 1.0, beta: float = 0.0, *,
                 with_csa: bool = True,
                 tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K4: cvtColor → cornerHarris [→ convertScaleAbs] in one pass over an
    RGB [H, W, 3] f32 frame; the gray tile lives in shared memory and never
    reaches HBM."""
    if not check_input(img, "harris_fused",
                       lambda s: len(s) == 3 and s[2] == 3, "[H, W, 3]"):
        return harris_fused_ref(img, block_size, k, alpha, beta,
                                with_csa=with_csa)
    _block_size_ok("harris_fused", block_size)
    H, W, _ = img.shape
    out = torch.empty((H, W), dtype=torch.float32, device=img.device)
    if out.numel():
        th, tw = _tile_ok("harris_fused", tile or fused_tile(
            H, W, block_size, device=img.device))
        _launch("harris_fused", library().repro_harris_fused_f32, img,
                img.data_ptr(), out.data_ptr(), H, W, block_size, float(k),
                int(with_csa), float(alpha), float(beta), th, tw)
    return out


def harris_fused_pair(img: torch.Tensor, block_size: int = 2,
                      k: float = 0.04, **kwargs) -> torch.Tensor:
    """cvtColor+cornerHarris fused module (no epilogue) — the database entry
    for the demo chain, where ``normalize`` separates cornerHarris from
    convertScaleAbs and limits the fusable run to two functions."""
    kwargs.pop("alpha", None)
    kwargs.pop("beta", None)
    return harris_fused(img, block_size, k, with_csa=False, **kwargs)
