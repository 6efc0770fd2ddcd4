"""Tile-shape autotuner with a persistent on-disk cache.

The stencil kernels are parameterised by a 2-D output tile; the best tile
depends on the kernel, the shape and dtype, and on the card that runs it.
:func:`autotune` sweeps a candidate list with a lower-is-better score (an
analytic roofline score by default) and memoises the winner in one JSON file
keyed by ``(kernel, shape, dtype, ..., device name, compute capability)``, so
a cache written on one card is never read for another.

Cache location: ``$REPRO_AUTOTUNE_CACHE`` if set, else ``build/autotune``
in the checkout.  Safe to delete at any time; the next run re-tunes.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Sequence

__all__ = ["AutotuneCache", "TuneResult", "autotune", "default_cache",
           "cache_dir", "device_key"]

REPO_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def cache_dir() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE",
                          str(REPO_BUILD_DIR / "autotune"))


def device_key(device: Any = None) -> tuple[str, str]:
    """(name, compute capability) of the card a tile is tuned for.

    A CUDA device reports its own; anything else is keyed as the H100
    spec-sheet prior the analytic scores are computed against.
    """
    import torch

    if device is not None and torch.device(device).type == "cuda":
        d = torch.device(device)
        major, minor = torch.cuda.get_device_capability(d)
        return torch.cuda.get_device_name(d), f"sm_{major}{minor}"
    return "h100-prior", "sm_90"


class AutotuneCache:
    """Tiny persistent key → winner store (one JSON file, write-through).

    ``hits``/``misses`` count :meth:`get` outcomes since construction.
    """

    def __init__(self, path: str | None = None):
        self._path = path
        self._mem: dict[str, Any] | None = None
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def path(self) -> str:
        return self._path or cache_dir()

    @property
    def file(self) -> str:
        return os.path.join(self.path, "autotune.json")

    def _load(self) -> dict[str, Any]:
        # every caller (get/put/clear/info) already holds self._lock
        if self._mem is None:
            try:
                with open(self.file) as f:
                    self._mem = json.load(f)  # owner: lock holder
            except (OSError, ValueError):
                self._mem = {}  # owner: lock holder
        return self._mem

    def get(self, key: str) -> Any | None:
        with self._lock:
            val = self._load().get(key)
            if val is None:
                self.misses += 1
            else:
                self.hits += 1
            return val

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            mem = self._load()
            mem[key] = value
            try:
                os.makedirs(self.path, exist_ok=True)
                tmp = f"{self.file}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(mem, f, indent=1, sort_keys=True)
                os.replace(tmp, self.file)       # atomic on POSIX
            except OSError:
                pass                             # the cache is best-effort

    def clear(self) -> None:
        """Forget every entry, in memory and on disk."""
        with self._lock:
            self._mem = {}
            try:
                os.remove(self.file)
            except OSError:
                pass                             # no file: nothing to remove

    def info(self) -> dict[str, Any]:
        """The cache file, its entry count, and the hits and misses of
        :meth:`get` so far."""
        with self._lock:
            return {"path": self.file, "entries": len(self._load()),
                    "hits": self.hits, "misses": self.misses}


default_cache = AutotuneCache()


@dataclass
class TuneResult:
    """Outcome of one autotune query."""

    best: Any                                   # winning candidate
    source: str                                 # "cache" | "tuned"
    scores: dict[str, float] = field(default_factory=dict)


def make_key(kernel: str, key_parts: Sequence[Any]) -> str:
    return kernel + "::" + ",".join(str(p) for p in key_parts)


def autotune(kernel: str, key_parts: Sequence[Any],
             candidates: Sequence[Any],
             score: Callable[[Any], float], *,
             cache: AutotuneCache | None = None) -> TuneResult:
    """Pick the candidate with the lowest score, memoised on disk.

    ``key_parts`` must capture everything the winner depends on (shape,
    dtype, static kernel params, the card); ``inf`` marks an infeasible
    candidate (a tile that overflows shared memory).  All-infeasible sweeps
    fall back to the first candidate.  Candidates round-trip through JSON,
    so tuples come back as lists and are compared as such.
    """
    if not candidates:
        raise ValueError(f"autotune({kernel!r}): empty candidate list")
    cache = cache if cache is not None else default_cache
    key = make_key(kernel, key_parts)
    as_json = [json.loads(json.dumps(c)) for c in candidates]
    hit = cache.get(key)
    if hit is not None and hit.get("best") in as_json:
        best = candidates[as_json.index(hit["best"])]
        return TuneResult(best=best, source="cache",
                          scores=hit.get("scores", {}))
    scores = {str(c): float(score(c)) for c in candidates}
    best = min(candidates, key=lambda c: scores[str(c)])
    if scores[str(best)] == float("inf"):
        best = candidates[0]
    cache.put(key, {"best": best, "scores": scores})
    return TuneResult(best=best, source="tuned", scores=scores)
