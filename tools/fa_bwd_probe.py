"""f32 K8 and K9 at the fault-tolerant driver's attention: this checkout's
kernels against another ``flash_attention_bwd.cu``'s, and against variants
of their own source, in turns.

    PYTHONPATH=src python3 tools/fa_bwd_probe.py [--variants] [OTHER_CSRC ...]

Needs one CUDA card and ``nvcc``.  Each OTHER_CSRC is the ``csrc``
directory of another tree ("other", "other2", ... in the output), for
example a parent commit's unpacked by ``git archive`` into ``build/``: its
``flash_attention_bwd.cu`` is built with its own headers and the port's
flags.  ``--variants`` also builds this checkout's source with anchored
lines changed (:data:`VARIANTS`; it stops if an anchor is missing):
without the S and dP products (``no_dots``), without the products that
accumulate dq, dk and dv (``no_axpy``), without either (``loads``; what
is left is the copies, the masks, the syncs and the stores), with
streamed tiles of 32 rows at hd <= 64 (``bn32``: two tiles, so a ring of
two stages and K8's two sweeps, where a block's keys or queries take more
than 32 rows), and with the S and dP products' loop over hd unrolled once
or twice instead of four times (``unroll1``, ``unroll2``).  At
``chip_smoke.driver_attention()``'s [8, 64, 10, 64] f32, under both of its
masks, each exact library's dq, delta, dk and dv are held to the plain
backward from K7's lse (``chip_smoke.grad_err``'s f32 limit; the first
three variants are wrong by design); then each kernel is timed as
``chip_smoke.device_ms`` times it (median of 25 launches behind an idle
gap, inputs cold in L2), the libraries in turns forward and back (other,
this, variants, then the reverse), beside a launch with no bytes
(``chip_smoke``'s launch floor).  Prints the card's name and power limit,
ptxas's lines for the f32 entries, a line per timing, and last one JSON
object of the times (ms).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DOTS = "  for (int d = 0; d < HD; d += 4) {"
AXPY = "  for (int j = 0; j < nj; j += 4) {"
UNROLL = "#pragma unroll 4\n  for (int d = 0; d < HD; d += 4) {"
BN = "static constexpr int BN = HD <= 64 ? 64 :"
# name -> (anchored line, its replacement) pairs, and whether it is exact
VARIANTS = {"no_dots": (((DOTS, DOTS.replace("d < HD", "d < 0")),), False),
            "no_axpy": (((AXPY, AXPY.replace("j < nj", "j < 0")),), False),
            "loads": (((DOTS, DOTS.replace("d < HD", "d < 0")),
                       (AXPY, AXPY.replace("j < nj", "j < 0"))), False),
            "bn32": (((BN, BN.replace("? 64 :", "? 32 :")),), True),
            "unroll1": (((UNROLL, UNROLL.replace("unroll 4", "unroll 1")),),
                        True),
            "unroll2": (((UNROLL, UNROLL.replace("unroll 4", "unroll 2")),),
                        True)}


def build_libraries(source: str, others: list, variants: dict,
                    typed) -> dict:
    """{name: (library, exact)}: ``csrc/<source>.cu`` of the other trees
    and this checkout's ``variants`` ({name: (anchored edits, exact)}),
    built at once with the port's flags; ``typed(lib)`` declares each
    library's argument types."""
    out = build.BUILD_DIR.parent / f"{source}_probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, other in enumerate(others):
        sources[f"other{i + 1 if i else ''}"] = (
            other / f"{source}.cu", other, True)
    src = (build.CSRC / f"{source}.cu").read_text()
    for name, (edits, exact) in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{source}.cu changed: no single line "
                                 f"{old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        sources[name] = (out / f"{name}.cu", build.CSRC, exact)
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{inc}", "-o",
         str(out / f"lib{name}.so"), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (cu, inc, _) in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        report(name, log)
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        typed(lib)
        libs[name] = (lib, sources[name][2])
    return libs


def typed_bwd(lib) -> None:
    for fn, n_ptr in ((lib.repro_flash_attention_bwd_dq, 7),
                      (lib.repro_flash_attention_bwd_dkv, 8)):
        fn.argtypes = [_P] * n_ptr + [_I] * 8 + [_F, _P]
        fn.restype = ctypes.c_int


def report(name: str, log: str) -> None:
    for entry, lines in cs.ptxas_report(log):
        if "_kernel<" in entry and entry.endswith("f32>"):
            print(f"[build] {name} {entry}: {'; '.join(lines)}")


def kernels(lib, causal: bool, window: int) -> tuple:
    """(dq, dkv): K8 and K9 of ``lib`` called as the port's wrappers call
    them, on tensors of the driver's shape."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def shape(q, k):
        B, T, H, hd = q.shape
        return fa._bwd_shape(q, (B, T, k.shape[1], H, hd), causal, window)

    def dq(q, k, v, do, lse, *_):
        out, delta = torch.empty_like(q), torch.empty(
            (q.shape[0] * q.shape[2], q.shape[1]), device=q.device)
        err = lib.repro_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out.data_ptr(), *shape(q, k),
            stream())
        cs.check(err == 0, f"K8 launch failed: {err}")
        return out, delta

    def dkv(q, k, v, do, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = lib.repro_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *shape(q, k), stream())
        cs.check(err == 0, f"K9 launch failed: {err}")
        return dk, dv
    return dq, dkv


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
    libs = {"this": (fa.bwd_library(), True)}
    report("this", build.build_logs.get("flash_attention_bwd", ""))
    libs.update(build_libraries("flash_attention_bwd", others,
                                VARIANTS if variants else {}, typed_bwd))
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
        sets = []
        for q, k, v, do in cs.driver_inputs(g, 4):
            lse = fa.flash_attention_fwd(q, k, v, causal, window)[1]
            sets.append((q, k, v, do, lse, fa.flash_attention_bwd_dq_ref(
                q, k, v, lse, do, causal, window)[1]))
        q, k, v, do, lse, want_delta = sets[0]
        want = (fa.flash_attention_bwd_dq_ref(q, k, v, lse, do, causal,
                                              window)[0],
                want_delta, *fa.flash_attention_bwd_dkv_ref(
                    q, k, v, do, lse, want_delta, causal, window))
        for name, (lib, exact) in libs.items():
            if not exact:
                continue
            dq, dkv = kernels(lib, causal, window)
            got_dq, got_delta = dq(q, k, v, do, lse)
            got = (got_dq, got_delta, *dkv(q, k, v, do, lse, got_delta))
            torch.cuda.synchronize()
            shares = [cs.grad_err(a, b)[1] for a, b in zip(got, want)]
            cs.check(max(shares) <= 1.0, f"{name} {kind}: {shares} of the "
                                         f"f32 limit (dq, delta, dk, dv)")
            print(f"[check] {name} {kind}: dq, delta, dk, dv at {shares} of "
                  f"the f32 limit")
        for turn, name in enumerate(order):
            dq, dkv = kernels(libs[name][0], causal, window)
            for label, fn in (("K8", dq), ("K9", dkv)):
                ms = cs.device_ms(fn, sets, label=f"{name} {label} {kind}")
                times.setdefault(f"{name} {label} {kind}", []).append(ms)
                print(f"[time] turn {turn} {name} {label} f32 {kind}: "
                      f"{ms:.5f} ms (launch floor {floor:.5f})")
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
