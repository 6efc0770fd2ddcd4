"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on one card, after building the CUDA kernels from
``src/repro_torch/kernels/csrc`` and holding each against its plain PyTorch
version there:

* the paper's Harris offload flow, ``courier_offload(corner_harris_demo(
  Library(db)), frame, db=make_harris_db())``, at the paper's 1080x1920 frame
  over a stream of 16 frames, with fusion off and on (K1-K4);
* the traced transformer served behind the request queue and the executor,
  ``serve_traced_transformer_demo``, at DeepSeek-67B widths (d 8192, 64
  heads, d_ff 22016, vocab 102400; 2 of its 95 layers, ~9.8 GB of f32
  weights): 8 requests of [512, 8192] in groups of 4 (K5, K6);
* the Harris pipeline served the same way, ``serve_pipeline_demo``, at
  1080x1920 (K1-K3 on the serving path).

Phases:

1. device   — fail without CUDA; print the card's name and power limit
2. build    — nvcc every CUDA source at once; print the build seconds
3. kernels  — each kernel against its plain version at the main paths'
              shapes and at ragged shapes, with the reference's tolerances;
              device times (median of back-to-back runs, input cold in L2)
              beside the bound, the plain version and the library call
4. main     — the offload path, fuse=False then fuse=True: hw rows resolved,
              launch counts moved, no host sync on the path, Switcher logs
              empty, outputs equal the plain app; ms/frame of the original
              app, run_sequential, run, and the card's own ms/frame
5. serve    — the traced transformer: K6 fused on the lm head, every rmsnorm
              on K5, launch counts moved by the expected numbers, results
              equal the untraced app (2e-4); latency p50/p95, requests/s,
              the card's own ms per group beside the wall ms.  Then the
              Harris pipeline behind the same server.
6. the ``kernels`` JSON line, the nvidia-smi line, and the result line

Any failed check raises: the script then exits non-zero without the result
line.  Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/harris.cu"
RMS_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
HBM_BW = 3.35e12              # H100 SXM HBM3, bytes/s (data sheet)
FP32_PEAK = 67e12             # H100 SXM float32 outside the tensor cores
N_FRAMES = 16
H, W = 1080, 1920
RAGGED = [(17, 23), (33, 130), (1081, 1919)]
L2_BYTES = 50 * 10**6
# the serving traffic: 8 requests of [512, d] each, served in groups of 4
TRAFFIC = dict(n_requests=8, max_batch=4, seq_len=512)
GROUP_ROWS = TRAFFIC["max_batch"] * TRAFFIC["seq_len"]  # 2048 rows a group
RMS_RAGGED = [(7, 130, 77), (513, 130, 77)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------------- #
def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}  count={torch.cuda.device_count()}  "
          f"torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


# --------------------------------------------------------------------------- #
# 2. build
# --------------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels import build, harris as hk, rmsnorm as rk

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    running = [build.start_build(s) for s in sources]       # all at once
    for b in running:
        build.finish_build(b)
    lib = hk.library()
    secs = time.perf_counter() - t0
    print(f"[build] {sources} built in {secs:.2f} s "
          f"(per source: {build.build_seconds})")
    for src in sources:
        for line in build.build_logs.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas {src}: {line.strip()}")
    for th, tw, bs in ((32, 32, 2), (16, 64, 3)):
        check(lib.repro_harris_tile_smem_bytes(th, tw, bs)
              == hk.tile_smem_bytes(th, tw, bs),
              "shared-memory reckoning differs between harris.cu and Python")
    check(rk.library().repro_rmsnorm_matmul_smem_bytes()
          == rk.gemm_smem_bytes(),
          "K6's shared-memory tile differs between rmsnorm.cu and Python")
    return secs


# --------------------------------------------------------------------------- #
# timing on the card
# --------------------------------------------------------------------------- #
def device_ms(fn, inputs, reps: int = 25, label: str = "",
              cycles: int = int(1e7)) -> float:       # ~5 ms at 1.98 GHz
    """Median device time of ``fn`` over ``reps`` runs.

    Each run is queued behind a short ``torch.cuda._sleep``, so the host has
    enqueued all of the run's launches before the card reaches them and the
    two events around it time the card, not Python's launch overhead.  (One
    sleep before all runs does not do: a plain version launches ~40 kernels
    a run, and the host blocks once about a thousand launches are pending.)
    ``inputs`` rotate so that together they exceed the 50 MB L2 cache: each
    run finds its input cold, as a frame of the stream does.
    """
    import torch

    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    for _ in range(4):
        times, ahead = [], True
        for i in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            a.record()
            fn(*inputs[i % len(inputs)])
            b.record()
            ahead = ahead and not a.query()      # the card was still asleep
            times.append((a, b))
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(a.elapsed_time(b) for a, b in times)
        cycles *= 4
    raise SmokeFailure(f"{label}: the host never got ahead of the card")


def rotation(make, nbytes: int) -> list:
    """Enough copies of an input that together they exceed the L2 cache."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]


# --------------------------------------------------------------------------- #
# 3. kernels against their plain versions
# --------------------------------------------------------------------------- #
def frame(h, w, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255).cuda()


def err_close(got, want, rtol=1e-5, atol=1e-3) -> float:
    """max |got - want|; fails beyond atol + rtol * |want| (cvt, csa)."""
    import torch

    d = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    check(bool((d <= atol + rtol * want.abs()).all()),
          f"kernel differs from its plain version by {d.max().item()}")
    return d.max().item()


def err_scaled(got, want, atol=1e-5) -> float:
    """max |got - want|; fails beyond atol * max |want| (Harris responses)."""
    import torch

    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    d = (got - want).abs().max().item()
    scale = want.abs().max().item() + 1e-9
    check(d / scale <= atol, f"Harris response differs by {d / scale} "
                             f"of its largest value")
    return d


def phase_kernels():
    import torch

    from repro_torch.kernels import harris as hk

    errs = {k: 0.0 for k in hk.LAUNCHES}
    for i, (h, w) in enumerate([(H, W), *RAGGED]):
        img = frame(h, w, 100 + i)
        gray = hk.cvt_color_ref(img)
        errs["cvt_color"] = max(errs["cvt_color"],
                                err_close(hk.cvt_color(img), gray))
        x = torch.randn((h, w), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i)) * 300
        for a, b in ((1.0, 0.0), (0.01, 5.0), (-2.0, 100.0)):
            errs["convert_scale_abs"] = max(
                errs["convert_scale_abs"],
                err_close(hk.convert_scale_abs(x, a, b),
                          hk.convert_scale_abs_ref(x, a, b)))
        for bs in (2, 3):
            want = hk.corner_harris_ref(gray, bs)
            errs["corner_harris"] = max(errs["corner_harris"],
                                        err_scaled(hk.corner_harris(gray, bs),
                                                   want))
            errs["harris_fused"] = max(
                errs["harris_fused"],
                err_scaled(hk.harris_fused(img, bs, with_csa=False), want),
                err_close(hk.harris_fused(img, bs, alpha=1e-6, beta=3.0),
                          hk.harris_fused_ref(img, bs, alpha=1e-6, beta=3.0)))
        torch.cuda.synchronize()
        print(f"[kernels] {h}x{w}: K1-K4 (bs 2 and 3, K4 with and without "
              f"the epilogue) match their plain versions")

    # device times at the main path's shapes and parameters (bs 2; K4 as
    # the pair module the fused path resolves)
    n_px = H * W
    imgs = rotation(lambda: (frame(H, W, 7),), 16 * n_px)
    grays = rotation(lambda: (hk.cvt_color_ref(frame(H, W, 8)),), 8 * n_px)
    w = torch.tensor([0.299, 0.587, 0.114], device="cuda")
    ops = {"cvt_color": 5, "corner_harris": 36, "convert_scale_abs": 4,
           "harris_fused": 41}                           # flops per pixel
    moved = {"cvt_color": 16, "corner_harris": 8, "convert_scale_abs": 8,
             "harris_fused": 16}                         # HBM bytes per pixel
    runs = {
        "cvt_color": (imgs, hk.cvt_color, hk.cvt_color_ref,
                      lambda im: im @ w),
        "corner_harris": (grays, hk.corner_harris, hk.corner_harris_ref, None),
        "convert_scale_abs": (grays, hk.convert_scale_abs,
                              hk.convert_scale_abs_ref, None),
        "harris_fused": (imgs, hk.harris_fused_pair,
                         lambda im: hk.harris_fused_ref(im, with_csa=False),
                         None),
    }
    rows = {}
    for name, (inputs, kern, plain, library) in runs.items():
        t_bytes = moved[name] * n_px / HBM_BW * 1e3
        t_ops = ops[name] * n_px / FP32_PEAK * 1e3
        rows[name] = {
            "ms": device_ms(kern, inputs, label=name),
            "plain_ms": device_ms(plain, inputs, label=f"{name} plain"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (device_ms(library, inputs, label=f"{name} library")
                           if library else None),
            "max_abs_err": errs[name],
        }
        r = rows[name]
        print(f"[kernels] {name:18s} kernel_ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) library_ms={r['library_ms']} "
              f"max_abs_err={r['max_abs_err']}")
    tiles = {f"{th}x{tw}": round(device_ms(
        lambda im, t=(th, tw): hk.harris_fused(im, with_csa=False, tile=t),
        imgs, label=f"tile {th}x{tw}"), 5)
        for th, tw in hk.TILE_CANDIDATES[:-1]}
    print(f"[kernels] harris_fused ms by tile (autotuned "
          f"{hk.fused_tile(H, W, 2, device='cuda')}): {json.dumps(tiles)}")
    return rows


def serve_args() -> dict:
    """The traced transformer at DeepSeek-67B widths
    (``repro_torch.configs.deepseek_67b``) under the serving traffic."""
    from dataclasses import asdict

    from repro_torch.configs.deepseek_67b import config

    return {**TRAFFIC, **asdict(config)}


def phase_rmsnorm_kernels():
    """K5 and K6 against their plain versions at the serving path's group
    shapes (K5 [2048, 8192]; K6 [2048, 8192] @ [8192, 102400]) and at ragged
    shapes; K5 to 1e-5 and K6 to 1e-4 (the reference's tolerances), then
    their device times beside the bound, the plain version and the library
    yardstick (F.rms_norm; for K6 the composition F.rms_norm + matmul, as
    no single PyTorch call computes it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rk

    g = torch.Generator("cuda").manual_seed(5)
    errs = {"rmsnorm": 0.0, "rmsnorm_matmul": 0.0}

    def inputs(n, d, dout):
        x = torch.randn((n, d), generator=g, device="cuda")
        s = torch.randn((d,), generator=g, device="cuda") * 0.2
        w = (torch.randn((d, dout), generator=g, device="cuda") * d ** -0.5
             if dout else None)
        return x, s, w

    d, vocab = serve_args()["d"], serve_args()["vocab"]
    for n, k, dout in [(GROUP_ROWS, d, vocab), *RMS_RAGGED]:
        x, s, w = inputs(n, k, dout)
        errs["rmsnorm"] = max(errs["rmsnorm"], err_close(
            rk.rmsnorm(x, s), rk.rmsnorm_ref(x, s), rtol=1e-5, atol=1e-5))
        errs["rmsnorm_matmul"] = max(errs["rmsnorm_matmul"], err_close(
            rk.rmsnorm_matmul(x, s, w), rk.rmsnorm_matmul_ref(x, s, w),
            rtol=1e-4, atol=1e-4))
        torch.cuda.synchronize()
        print(f"[kernels] rmsnorm [{n}, {k}] and rmsnorm_matmul "
              f"[{n}, {k}] @ [{k}, {dout}] match their plain versions")
        del x, s, w

    rows = {}
    # K5: inputs rotate past the L2 cache, as the serving path's do
    norm_in = rotation(lambda: inputs(GROUP_ROWS, d, 0)[:2],
                       8 * GROUP_ROWS * d)
    one = [(x, 1.0 + s) for x, s in norm_in]
    n_el = GROUP_ROWS * d
    t_bytes = (8 * n_el + 4 * d) / HBM_BW * 1e3
    t_ops = 5 * n_el / FP32_PEAK * 1e3
    rows["rmsnorm"] = {
        "ms": device_ms(rk.rmsnorm, norm_in, label="rmsnorm"),
        "plain_ms": device_ms(rk.rmsnorm_ref, norm_in, label="rmsnorm plain"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": device_ms(
            lambda x, s1: F.rms_norm(x, (d,), s1, rk.EPS), one,
            label="rmsnorm library"),
        "library": "F.rms_norm"}
    del norm_in, one
    # K6 at the lm head of a group of 4: w alone (3.36 GB) is 67x the L2
    x, s, w = inputs(GROUP_ROWS, d, vocab)
    s1 = 1.0 + s
    t_ops = 2.0 * GROUP_ROWS * d * vocab / FP32_PEAK * 1e3
    t_bytes = 4.0 * (GROUP_ROWS * d + d + d * vocab
                     + GROUP_ROWS * vocab) / HBM_BW * 1e3
    kw = dict(reps=5, cycles=int(4e7))
    rows["rmsnorm_matmul"] = {
        "ms": device_ms(rk.rmsnorm_matmul, [(x, s, w)], label="K6", **kw),
        "plain_ms": device_ms(rk.rmsnorm_matmul_ref, [(x, s, w)],
                              label="K6 plain", **kw),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": device_ms(
            lambda x, w: torch.matmul(F.rms_norm(x, (d,), s1, rk.EPS), w),
            [(x, w)], label="K6 library", **kw),
        "library": "F.rms_norm + torch.matmul (a composition)"}
    del x, s, w, s1
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r["max_abs_err"] = errs[name]
        print(f"[kernels] {name:18s} kernel_ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) library_ms={r['library_ms']:.5f} "
              f"[{r['library']}] max_abs_err={r['max_abs_err']}")
    return rows


# --------------------------------------------------------------------------- #
# 4. the main path
# --------------------------------------------------------------------------- #
def host_ms_per_frame(fn, frames) -> float:
    import torch

    fn(frames)                                   # warmup
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn(frames)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / len(frames))
    return best


def phase_main_path():
    import torch

    from repro_torch.core import Library, courier_offload
    from repro_torch.core.placement import is_hw
    from repro_torch.kernels import harris as hk
    from repro_torch.models.harris import (corner_harris_demo, make_frames,
                                           make_harris_db)

    frames = make_frames(N_FRAMES, H, W, seed=0, device="cuda")
    plain_app = corner_harris_demo(Library(make_harris_db(with_hw=False)))
    want = [plain_app(f) for f in frames]
    launches, times = {k: 0 for k in hk.LAUNCHES}, {}
    for fuse in (False, True):
        db = make_harris_db(with_hw=True)
        app = corner_harris_demo(Library(db))
        off = courier_offload(app, frames[0], db=db, fuse=fuse)
        nodes = {n.fn_key: n for n in off.pipeline.ir.nodes}
        hw_keys = (["cvtColor+cornerHarris", "convertScaleAbs"] if fuse else
                   ["cvtColor", "cornerHarris", "convertScaleAbs"])
        for k in hw_keys:
            check(k in nodes and is_hw(nodes[k].placement),
                  f"fuse={fuse}: {k} is not a hw node ({sorted(nodes)})")
        check(not is_hw(nodes["normalize"].placement), "normalize went hw")

        hk.reset_launches()
        torch.cuda.set_sync_debug_mode("error")   # the path never waits
        try:                                      # for the card
            got = off.map(frames)                 # the main path
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(hk.LAUNCHES)
        expect = ({"harris_fused": N_FRAMES, "convert_scale_abs": N_FRAMES}
                  if fuse else {"cvt_color": N_FRAMES,
                                "corner_harris": N_FRAMES,
                                "convert_scale_abs": N_FRAMES})
        check(counts == {k: expect.get(k, 0) for k in counts},
              f"fuse={fuse}: launch counts {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        check(off.fallbacks == [] and off.plan.fallback_log == [],
              f"Off-load Switcher fell back: {off.fallbacks} "
              f"{off.plan.fallback_log}")
        for g, r in zip(got, want):
            check(g.shape == (H, W) and bool(torch.isfinite(g).all())
                  and float(g.min()) >= 0.0 and float(g.max()) <= 255.0,
                  "main-path output is not a finite [0, 255] frame")
            torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)
        print(f"[main] fuse={fuse}: {off.pipeline.plan.n_stages} stages "
              f"{[s.node_names for s in off.pipeline.plan.stages]}; "
              f"launches {counts}; outputs equal the plain app (1e-3)")

        t = {"original_ms_per_frame":
             host_ms_per_frame(lambda fs: [app(f) for f in fs], frames),
             "run_sequential_ms_per_frame":
             host_ms_per_frame(off.pipeline.run_sequential, frames),
             "run_ms_per_frame": host_ms_per_frame(off.pipeline.run, frames),
             # the card's own time for one frame through the pipeline, with
             # the host ahead of it: what the stream would take if the host
             # never held the card back
             "device_ms_per_frame": device_ms(
                 off.pipeline, [(f,) for f in frames], reps=N_FRAMES,
                 label=f"pipeline fuse={fuse}")}
        t["device_idle_share"] = 1.0 - (t["device_ms_per_frame"]
                                        / t["run_ms_per_frame"])
        times[f"fuse={fuse}"] = t
        print(f"[main] fuse={fuse}: " + "  ".join(
            f"{k}={v:.4f}" for k, v in t.items()))
    return launches, times


# --------------------------------------------------------------------------- #
# 5. serving: the traced transformer, then the Harris pipeline
# --------------------------------------------------------------------------- #
def phase_serve(k6_ms: float):
    import torch

    from repro_torch.kernels import harris as hk, rmsnorm as rk
    from repro_torch.launch.serve import (serve_pipeline_demo,
                                          serve_traced_transformer_demo)

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    rk.reset_launches()
    t0 = time.perf_counter()
    args = serve_args()
    st = serve_traced_transformer_demo(device="cuda", **args)
    torch.cuda.synchronize()
    counts = dict(rk.LAUNCHES)
    secs = time.perf_counter() - t0
    groups = st["warmup_groups"] + st["executor"]["groups_admitted"]
    check(st["fused_nodes"] == ["rmsnorm_4+matmul_0"],
          f"lm head not fused: {st['fused_nodes']}")
    check(st["hw_nodes"] == {**{f"rmsnorm_{i}": "rmsnorm" for i in range(4)},
                             "rmsnorm_4+matmul_0": "rmsnorm+matmul"},
          f"hw nodes {st['hw_nodes']}")
    check(counts == {"rmsnorm": 4 * groups, "rmsnorm_matmul": groups},
          f"launches {counts} for {groups} groups")
    check(st["requests_served"] == args["n_requests"] and st["failed"] == 0,
          f"served {st['requests_served']} of {args['n_requests']}")
    check(st["results_match"],
          f"served results differ from the untraced app by "
          f"{st['max_rel_err']} of their largest value")
    lat = st["latency_ms"]
    served_groups = st["executor"]["groups_admitted"]
    wall = 1e3 * st["requests_served"] / st["throughput_rps"] / served_groups
    dev = st["device_ms_per_group"]
    out = {"requests_served": st["requests_served"],
           "groups": served_groups, "warmup_groups": st["warmup_groups"],
           "latency_p50_ms": lat["p50"], "latency_p95_ms": lat["p95"],
           "requests_per_s": st["throughput_rps"],
           "wall_ms_per_group": wall, "device_ms_per_group": dev,
           "device_idle_share": 1.0 - dev / wall,
           "k6_share_of_device_time": k6_ms / dev,
           "max_rel_err": st["max_rel_err"], "stages": st["stages"],
           "profile": st["profile"], "seconds": secs}
    print(f"[serve] traced transformer at DeepSeek-67B widths: "
          f"{st['requests_served']} requests in {served_groups} groups over "
          f"{st['n_stages']} stages {st['stages']}; fused "
          f"{st['fused_nodes']}; launches {counts}; results match the "
          f"untraced app (max rel err {st['max_rel_err']})")
    print("[serve] " + "  ".join(
        f"{k}={out[k]}" for k in ("latency_p50_ms", "latency_p95_ms",
                                  "requests_per_s", "wall_ms_per_group",
                                  "device_ms_per_group", "device_idle_share",
                                  "k6_share_of_device_time")))
    torch.cuda.empty_cache()

    hk.reset_launches()
    sp = serve_pipeline_demo(n_requests=N_FRAMES, max_batch=4, size=(H, W),
                             device="cuda")
    torch.cuda.synchronize()
    hcounts = dict(hk.LAUNCHES)
    check(sp["requests_served"] == N_FRAMES and sp["results_match"],
          f"Harris serving: {sp['requests_served']} served, max abs err "
          f"{sp['max_abs_err']}")
    ran = hcounts["cvt_color"]
    check(ran >= N_FRAMES + 1 and hcounts == {
        "cvt_color": ran, "corner_harris": ran, "convert_scale_abs": ran,
        "harris_fused": 0}, f"Harris serving launches {hcounts}")
    print(f"[serve] Harris pipeline: {sp['requests_served']} frames, "
          f"{sp['batches']} batches, launches {hcounts}, p50 "
          f"{sp['latency_ms']['p50']} ms, max abs err {sp['max_abs_err']}")
    return counts, hcounts, out


def main() -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    name, smi = phase_device()
    import torch

    build_s = phase_build()
    rows = phase_kernels()
    rows.update(phase_rmsnorm_kernels())
    launches, times = phase_main_path()
    counts, hcounts, served = phase_serve(rows["rmsnorm_matmul"]["ms"])
    for k, v in (*counts.items(), *hcounts.items()):
        launches[k] = launches.get(k, 0) + v
    replaces = {"cvt_color": "src/repro/kernels/harris.py:44",
                "corner_harris": "src/repro/kernels/harris.py:101",
                "convert_scale_abs": "src/repro/kernels/harris.py:124",
                "harris_fused": "src/repro/kernels/harris.py:247",
                "rmsnorm": "src/repro/kernels/rmsnorm.py:28",
                "rmsnorm_matmul": "src/repro/kernels/rmsnorm.py:67"}
    kernels = [{"name": k, "route": "cuda",
                "source": RMS_SOURCE if k.startswith("rmsnorm") else SOURCE,
                "replaces": replaces[k], "launches": launches[k],
                **{f: rows[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")}}
               for k in replaces]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched on the "
                                 f"main paths")
    print(json.dumps({"build_s": build_s, "main_path": times,
                      "frame": [H, W], "frames": N_FRAMES,
                      "serve_transformer": served}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
