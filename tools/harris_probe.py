"""What holds K2, K3 and K4 above their bound?  Time variants of harris.cu.

    PYTHONPATH=src python3 tools/harris_probe.py

Needs one CUDA card and ``nvcc``.  Builds ``csrc/harris.cu`` as it is
("base") and with one anchored line changed for each variant, all at once
with the port's flags, then times K2 (``corner_harris``, block size 2),
K3 (``convert_scale_abs``) and K4 (``harris_fused`` without the epilogue)
of every variant at the paper's 1080x1920 frame and the autotuned tile,
as ``chip_smoke.py`` times them (``device_ms``: median of back-to-back
runs behind an idle gap, inputs rotating past the 50 MB L2).  The
variants, in turns, three rounds:

* ``min8``: K2/K4's blocks are built for 8 resident an SM (at most 64
  registers a thread), not 6;
* ``stcs``: K3 stores with the streaming hint ``__stcs``;
* ``unroll2``: K3 issues two loads a thread before it uses one, not four;
* ``no_stencil``: K2/K4 copy, convert and store as they are but compute no
  Sobel product (their outputs are zeros, not held to anything): what the
  copies and stores cost without the arithmetic;
* ``my4``: K2/K4's threads own 4 x 4 micro-tiles, not 2 x 4, in blocks of
  64 threads (fewer Sobel products and shared-memory loads an output, more
  registers).

Beside them, three yardsticks: the same-bytes copy ``out.copy_(gray)`` of
the gray plane (what HBM gives at this size), and what a launch costs with
no bytes to move, timed the same way: K3 on 4 elements, and PyTorch's own
``add_`` on 4 elements.  Every variant's outputs but no_stencil's are held
to the port's plain versions, bit for bit, before it is timed.

Prints the card's name and power limit, ptxas's register and spill lines
for each variant, a line per round, and last one JSON object of all times
(ms).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (device_ms, rotation, frame)
from repro_torch.kernels import harris as hk  # noqa: E402
from repro_torch.kernels.build import (  # noqa: E402
    BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path)

H, W, BS, K = 1080, 1920, 2, 0.04
VARIANTS = {
    "base": [],
    "min8": [("constexpr int kTileMinBlocks = 6;",
              "constexpr int kTileMinBlocks = 8;")],
    "stcs": [("out[i0 + j * kThreads] = csa(v[j], alpha, beta);",
              "__stcs(&out[i0 + j * kThreads], csa(v[j], alpha, beta));")],
    "unroll2": [("constexpr int kCsaUnroll = 4; ",
                 "constexpr int kCsaUnroll = 2; ")],
    "my4": [("constexpr int kTileThreads = 128;",
             "constexpr int kTileThreads = 64;"),
            ("constexpr int kMY = 2, kMX = 4;", "constexpr int kMY = 4, kMX = 4;")],
    "no_stencil": [("  for (int py = 0; py < kMY + BS - 1; ++py) {",
                    "  for (int py = 0; py < 0; ++py) {")],
}


def variant_source(edits: list) -> str:
    src = (CSRC / "harris.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"harris.cu changed: no single line {old!r}")
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    """Each variant's library, built at once, with its argument types."""
    out = BUILD_DIR.parent / "harris_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(edits))
        procs[name] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for entry, lines in cs.ptxas_report(log):
            print(f"[build] {name} {entry}: {cs.ptxas_resources(lines)}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, args in hk._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def kernels(lib, tile) -> dict:
    """K2, K3 and K4 of one variant's library, as the wrappers call them."""
    def call(fn, x, shape, *args):
        out = torch.empty(shape, device="cuda")
        err = fn(x.data_ptr(), out.data_ptr(), *args,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: {err}")
        return out

    return {
        "corner_harris": lambda g: call(lib.repro_corner_harris_f32, g,
                                        g.shape, H, W, BS, K, *tile),
        "convert_scale_abs": lambda x: call(lib.repro_convert_scale_abs_f32,
                                            x, x.shape, x.numel(), 1.0, 0.0),
        "harris_fused": lambda im: call(lib.repro_harris_fused_f32, im,
                                        im.shape[:2], H, W, BS, K, 0, 1.0,
                                        0.0, *tile),
    }


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    libs = build_all()
    tile = hk.fused_tile(H, W, BS, device="cuda")
    imgs = cs.rotation(lambda: (cs.frame(H, W, 7),), 16 * H * W)
    grays = cs.rotation(lambda: (hk.cvt_color_ref(cs.frame(H, W, 8)),),
                        8 * H * W)
    inputs = {"corner_harris": grays, "convert_scale_abs": grays,
              "harris_fused": imgs}
    img, gray = imgs[0][0], grays[0][0]
    want = {"corner_harris": hk.corner_harris_ref(gray, BS, K),
            "convert_scale_abs": hk.convert_scale_abs_ref(gray),
            "harris_fused": hk.corner_harris_ref(hk.cvt_color_ref(img), BS, K)}
    ks = {name: kernels(lib, tile) for name, lib in libs.items()}
    for name, fns in ks.items():
        for k, fn in fns.items():
            if name == "no_stencil" and k != "convert_scale_abs":
                continue
            got = fn(img if k == "harris_fused" else gray)
            if not torch.equal(got, want[k]):
                raise SystemExit(f"{name} {k} differs from its plain version")
    print(f"[check] every variant's K2, K3 and K4 (no_stencil's K3) equal "
          f"their plain "
          f"versions bit for bit (tile {tile})")
    plane = torch.empty((H, W), device="cuda")
    tiny = torch.randn(4, device="cuda")
    times: dict = {"tile": list(tile), "rounds": []}
    for r in range(3):
        row = {name: {k: cs.device_ms(fn, inputs[k], label=f"{name} {k}")
                      for k, fn in fns.items()} for name, fns in ks.items()}
        row["copy"] = cs.device_ms(lambda g: plane.copy_(g), grays,
                                   label="copy")
        row["floor_k3"] = cs.device_ms(
            ks["base"]["convert_scale_abs"], [(tiny,)], label="floor")
        row["floor_torch"] = cs.device_ms(lambda t: t.add_(1.0), [(tiny,)],
                                          label="torch floor")
        times["rounds"].append(row)
        print(f"[round {r}] " + json.dumps(row))
    print(json.dumps(times))


if __name__ == "__main__":
    main()
