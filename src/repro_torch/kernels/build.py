"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<digest>.so`` in the checkout, at first use:
nothing is built when a module is imported, so a machine without ``nvcc``
still imports (and tests) the whole package.  The digest covers the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}      # name -> wall seconds of its nvcc
build_logs: dict[str, str] = {}           # name -> nvcc's output (ptxas -v),
                                          # kept beside the library


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


@dataclass
class Build:
    """One running ``nvcc``: its source name, process, output and start."""

    name: str
    proc: subprocess.Popen
    tmp: Path
    t0: float


def start_build(name: str) -> Build | None:
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists.

    The caller waits with :func:`finish_build`, so several sources can
    compile at once.
    """
    out = library_path(name)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            build_logs[name] = log.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return Build(name, proc, tmp, t0)


def finish_build(build: Build | None) -> None:
    """Wait for a build from :func:`start_build`; raise with nvcc's output
    if it failed."""
    if build is None:
        return
    log, _ = build.proc.communicate()
    build_seconds[build.name] = time.perf_counter() - build.t0
    build_logs[build.name] = log
    if build.proc.returncode != 0:
        build.tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{build.name}.cu "
                           f"(exit {build.proc.returncode}):\n{log}")
    library_path(build.name).with_suffix(".log").write_text(log)
    os.replace(build.tmp, library_path(build.name))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            finish_build(start_build(name))
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


# --------------------------------------------------------------------------- #
# what every kernel wrapper does around its launch
# --------------------------------------------------------------------------- #
def check_input(x, name: str, shape_ok, what: str, dtypes=None) -> bool:
    """Validate a kernel input; True when it lies on a CUDA device (launch
    the kernel), False when it lies on the CPU (take the plain version).
    ``dtypes`` are the types the kernel takes (float32 alone by default)."""
    import torch

    dtypes = tuple(dtypes or (torch.float32,))

    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(x).__name__}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cpu":
        return False
    if x.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: the kernel takes {names}, got {x.dtype}")
    if not shape_ok(x.shape):
        raise ValueError(f"{name}: expected {what}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    return True


def launch(counts: dict, name: str, fn, error_string, x, *args,
           route: str | None = None) -> None:
    """Call ``fn(*args, stream)`` on ``x``'s device and current stream;
    raise with the CUDA error if the launch was refused, else count it in
    ``counts[name]``, or ``counts[name][route]`` for a kernel with routes
    (the one place a launch is counted)."""
    import torch

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed "
                           f"({err}: {error_string(err).decode()})")
    if route is None:
        counts[name] += 1
    else:
        counts[name][route] += 1
