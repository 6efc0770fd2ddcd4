"""f32 K7 at the fault-tolerant driver's attention: this checkout's kernel
against another ``flash_attention.cu``'s, and against variants of its own
source, in turns.

    PYTHONPATH=src python3 tools/fa_fwd_probe.py [--variants] [OTHER_CSRC ...]

Needs one CUDA card and ``nvcc``.  Each OTHER_CSRC is the ``csrc``
directory of another tree ("other", "other2", ... in the output), for
example a parent commit's unpacked by ``git archive`` into ``build/``: its
``flash_attention.cu`` is built with its own headers and the port's flags.
``--variants`` also builds this checkout's source with anchored lines
changed (:data:`VARIANTS`; it stops if an anchor is missing): without the
S = Q K^T product (``no_s``: every score 0), without the O += P V product
(``no_pv``), and without either (``loads``: what is left is the copies,
the softmax, the syncs and the stores).  All three are wrong by design.
At ``chip_smoke.driver_attention()``'s [8, 64, 10, 64] f32, under both of
its masks, each exact library's o and lse are held to ``flash_attention_ref``
(``chip_smoke.flash_err``'s f32 limits); then each is timed as
``chip_smoke.device_ms`` times it (median of 25 launches behind an idle
gap, inputs cold in L2), in turns forward and back (other, this, variants,
then the reverse), beside ``F.scaled_dot_product_attention`` on the same
inputs and a launch with no bytes (``chip_smoke``'s launch floor).  Prints
the card's name and power limit, ptxas's lines for the f32 entries, a line
per timing, and last one JSON object of the times (ms).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
from fa_bwd_probe import _F, _I, _P, build_libraries, report  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

S_LOOP = "  for (int d = 0; d < HD; d += 4) {"
PV_LOOP = "  for (int j = 0; j < nj; j += 4) {"
NO_S = (S_LOOP, S_LOOP.replace("d < HD", "d < 0"))
NO_PV = (PV_LOOP, PV_LOOP.replace("j < nj", "j < 0"))
# name -> (anchored line, its replacement) pairs, and whether it is exact
VARIANTS = {"no_s": ((NO_S,), False), "no_pv": ((NO_PV,), False),
            "loads": ((NO_S, NO_PV), False)}


def typed_fwd(lib) -> None:
    lib.repro_flash_attention_fwd.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_flash_attention_fwd.restype = ctypes.c_int


def k7(lib, causal: bool, window: int):
    """K7 of ``lib`` called as ``fa.flash_attention_fwd`` calls it, f32."""
    def fwd(q, k, v, *_):
        B, T, H, hd = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B * H, T), device=q.device)
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, T, k.shape[1], H, hd, 0, int(causal),
            window, 1.0 / hd ** 0.5,
            torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"K7 launch failed: {err}")
        return o, lse
    return fwd


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    args = sys.argv[1:]
    variants = "--variants" in args
    others = [Path(a).resolve() for a in args if a != "--variants"]
    libs = {"this": (fa.library(), True)}
    report("this", build.build_logs.get("flash_attention", ""))
    libs.update(build_libraries("flash_attention", others,
                                VARIANTS if variants else {}, typed_fwd))
    floor = cs.device_ms(lambda t: t.add_(1.0), [
        (torch.zeros(1, device="cuda"),)], label="launch floor")
    g = torch.Generator("cuda").manual_seed(23)
    _, _, masks = cs.driver_attention()
    names = sorted(libs, key=lambda n: (not n.startswith("other"),
                                        n != "this", n))
    order = names + names[::-1]
    times: dict = {"launch_floor_ms": floor}
    for causal, window in masks:
        kind = f"window {window}" if window else "causal"
        sets = cs.driver_inputs(g, 3)
        for name, (lib, exact) in libs.items():
            if exact:
                err, worst = cs.flash_err(*sets[0], causal, window,
                                          fwd=k7(lib, causal, window))
                print(f"[check] {name} {kind}: max abs err {err}, {worst} "
                      f"of the element-wise f32 limit")
        sdpa, backend = cs.sdpa_f32(window)
        for turn, name in enumerate(order):
            ms = cs.device_ms(k7(libs[name][0], causal, window), sets,
                              label=f"{name} K7 {kind}")
            times.setdefault(f"{name} K7 {kind}", []).append(ms)
            print(f"[time] turn {turn} {name} K7 f32 {kind}: {ms:.5f} ms "
                  f"(launch floor {floor:.5f})")
        ms = cs.device_ms(sdpa, [tuple(t.transpose(1, 2) for t in x)
                                 for x in sets], label=f"SDPA {kind}")
        times[f"SDPA {kind}"] = ms
        print(f"[time] F.scaled_dot_product_attention ({backend}) f32 "
              f"{kind}: {ms:.5f} ms")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
