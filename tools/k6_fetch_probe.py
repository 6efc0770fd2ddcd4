"""Does K6 wait on what it fetches from L2?  Time it with less to fetch.

    PYTHONPATH=src python3 tools/k6_fetch_probe.py

Needs one CUDA card and ``nvcc``.  Builds ``csrc/rmsnorm.cu`` four times,
with the same flags as the port: as it is ("base"), and with K6's producer
copying on the 16-byte path only half of each k step's x rows ("half_x"),
half of its w rows ("half_w"), or both.  A block streams 16 KB of x and
16 KB of w a k step, so half_x and half_w fetch a quarter less and both
half as much; the products, the split and the barriers stay as they are.
Each variant runs at the served lm head, ``[2048, 8192] @ [8192, 102400]``
f32, back to back as a loaded card runs it: after 3 s of base to bring
the card to its loaded clocks, in the order base, half_x, half_w, both,
three times, each time the median of 10 launches, with the card's median
SM clock and power draw over those launches from ``nvidia-smi`` and their
product, millions of SM cycles a launch, which the clock does not move.
Last, base once more as ``chip_smoke.py`` times K6, each launch behind an
idle gap of ``torch.cuda._sleep(4e7)``, to show what the gap does to the
clock.  The variants' outputs are wrong by
design (rows not copied hold what the ring held before); base's output is
held to the port's wrapper, bit for bit.

Prints the card's name and power limit, ptxas's spill lines for each
variant, a line per timing, and last one JSON object of all times (ms),
clocks (MHz), draws (W) and cycles (millions).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from datetime import datetime

import torch

from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

M, K, N = 2048, 8192, 102400
X_LOOP = "for (int j = 0; j < 8; ++j) {          // x: row's chunk c at c ^ r"
W_LOOP = "for (int j = 0; j < 8; ++j) {          // w: k's chunk q at q ^ k/4"
VARIANTS = {"base": (), "half_x": (X_LOOP,), "half_w": (W_LOOP,),
            "both": (X_LOOP, W_LOOP)}


def variant_source(loops: tuple) -> str:
    src = (CSRC / "rmsnorm.cu").read_text()
    for loop in loops:
        if src.count(loop) != 1:
            raise SystemExit(f"rmsnorm.cu changed: no single loop {loop!r}")
        src = src.replace(loop, loop.replace("j < 8", "j < 4"))
    return src


def build_all() -> dict:
    """Each variant's ``repro_rmsnorm_matmul_f32``, built at once."""
    out = BUILD_DIR.parent / "k6_fetch_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, loops in VARIANTS.items():
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(loops))
        cmd = [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC}", "-o",
               str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        print(f"[build] {name}: {spills}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = lib.repro_rmsnorm_matmul_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    fns = build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(M, K, device="cuda", generator=g)
    s = 0.1 * torch.randn(K, device="cuda", generator=g)
    w = torch.randn(K, N, device="cuda", generator=g) / K ** 0.5
    out = torch.empty(M, N, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(name: str) -> None:
        err = fns[name](x.data_ptr(), s.data_ptr(), w.data_ptr(),
                        out.data_ptr(), M, N, K, rk.EPS, stream)
        if err:
            raise SystemExit(f"{name}: launch failed with CUDA error {err}")

    run("base")
    torch.cuda.synchronize()
    if not torch.equal(out, rk.rmsnorm_matmul(x, s, w)):
        raise SystemExit("base differs from the port's K6 wrapper")

    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + 3.0
        while time.perf_counter() < t_end:
            run("base")
            torch.cuda.synchronize()
        windows = []

        def timed(name: str, label: str, gap: int = 0) -> None:
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(10)]
            t0 = datetime.now()
            for a, b in ev:
                if gap:
                    torch.cuda._sleep(gap)
                a.record()
                run(name)
                b.record()
            torch.cuda.synchronize()
            windows.append((label, t0, datetime.now(), statistics.median(
                a.elapsed_time(b) for a, b in ev)))

        for _ in range(3):
            for name in VARIANTS:
                timed(name, name)
        timed("base", "base_gapped", gap=int(4e7))
        time.sleep(0.1)
    finally:
        sampler.terminate()
    samples = []
    for line in sampler.communicate()[0].splitlines():
        stamp, clock, draw = (f.strip() for f in line.split(","))
        samples.append((datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f"),
                        float(clock), float(draw)))
    result = {label: {"ms": [], "sm_mhz": [], "watts": [], "mcycles": []}
              for label in [*VARIANTS, "base_gapped"]}
    for label, t0, t1, ms in windows:
        inside = [(c, p) for t, c, p in samples if t0 <= t <= t1]
        clock = statistics.median(c for c, _ in inside) if inside else None
        draw = statistics.median(p for _, p in inside) if inside else None
        cycles = ms * clock / 1e3 if inside else None
        for key, v in (("ms", ms), ("sm_mhz", clock), ("watts", draw),
                       ("mcycles", cycles)):
            result[label][key].append(v)
        print(f"[time] {label}: {ms} ms, SM {clock} MHz, {draw} W, "
              f"{cycles} M cycles ({len(inside)} samples)")
    print(json.dumps({"card": smi, "shape": [M, K, N], **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
