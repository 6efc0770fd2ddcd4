"""Quickstart — the paper's Fig. 1 flow on its own case study, on the H100.

An *unmodified* Harris corner-detection app is traced while it runs
(Frontend, Steps 1-3), the call graph incl. I/O data is rendered (Fig. 4),
the Backend looks up the CUDA "hardware modules" in the database and the
Pipeline Generator builds a balanced mixed sw/hw pipeline (Step 8), which
the Function Off-loader deploys as a drop-in replacement (Step 9).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--fuse]
"""
from __future__ import annotations

import argparse
import time

import torch

from .core import courier_offload, resolve_device, synchronize
from .core.tracer import Library
from .models.harris import corner_harris_demo, make_frames, make_harris_db


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--fuse", action="store_true",
                    help="let the cost model fuse cvtColor+cornerHarris")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # The "running binary": user code over a library namespace, never edited.
    db = make_harris_db(with_hw=True)
    app = corner_harris_demo(Library(db))
    frames = make_frames(args.frames, args.height, args.width, seed=0,
                         device=device)

    # Steps 1-9 in one call: trace -> DB lookup -> balanced partition ->
    # token pipeline -> deployable wrapper.
    off = courier_offload(app, frames[0], db=db, n_threads=3, fuse=args.fuse)

    print(f"=== device: {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'})")
    print("=== Fig.4: traced call graph (I/O data + profile) ===")
    print(off.ir.render())
    print("\n=== Step 8: generated pipeline ===")
    print(off.describe())

    # Deployed run: same semantics, pipelined execution.
    ref = app(frames[0])
    got = off(frames[0])
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    if off.fallbacks or off.plan.fallback_log:
        raise RuntimeError(f"the Off-load Switcher fell back: "
                           f"{off.fallbacks + off.plan.fallback_log}")
    print("\nsemantics preserved: pipeline(f) == original(f)")

    for name, fn in [("original (unmodified app)",
                      lambda: [app(f) for f in frames]),
                     ("Courier pipeline (token stream)",
                      lambda: off.map(frames))]:
        synchronize(fn())                      # warmup
        t0 = time.perf_counter()
        synchronize(fn())
        ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        print(f"{name:34s}: {ms:7.3f} ms/frame")


if __name__ == "__main__":
    main()
