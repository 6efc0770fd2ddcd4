"""Per-request KV-cache slot pool — stateful decode serving.

Courier's pipeline treats every token as a pure function of its inputs;
decode-style traffic is not: step ``t`` of a request attends over the
keys/values written by steps ``0..t-1``.  Re-running the full prefix per
step turns an O(1) decode step into O(t) — the workload continuous
batching exists to serve becomes the workload that cannot use it.

:class:`KVSlotPool` is the state layer: a fixed arena of per-request cache
slots, keyed by an integer ``slot_id`` that rides through the pipeline env
as an ordinary stage input.  The serving layer allocates a slot at
admission, threads the id through every decode step of the request, and
frees it at retirement — on EVERY terminal path (served/shed/expired/
failed), through the request's ``on_finish`` release hook.

Slot ``-1`` is the *dead-row* id: padding rows and evicted seats in a
continuously-batched group carry it, and every pool mutation on it is a
no-op — a padded group can run the stateful stage without double-writing
any live request's cache.

The transitions and the lock are the JAX package's
(``src/repro/runtime/kvstate.py``).  One thing differs: the arena is a set
of torch tensors on the pool's device — the card unless the caller asks
for ``device="cpu"`` — where the JAX pool keeps host numpy arrays.  On the
card a host arena would copy every prefix across PCIe on each decode step;
here a read and an append are copies within the card, queued on the stream
the decode stage runs on.  Stateful nodes stay ``serial_only`` (one worker
observes writes in token order), unfused and off the hw rows — the
``state-slot`` verify rule rejects plans that violate any of those.
"""
from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping

import torch

from ..core.placement import resolve_device

__all__ = ["KVSlotPool", "DecodeSession", "SlotError"]


class SlotError(RuntimeError):
    """Illegal slot-pool transition (double free, use-after-free,
    exhaustion, alias).  Loud by design: every one of these is a serving
    bug that would otherwise corrupt another request's cache."""


class KVSlotPool:
    """Fixed arena of per-request cache slots.

    Parameters
    ----------
    n_slots:
        Concurrent live requests the arena supports.  ``alloc`` raises
        :class:`SlotError` when exhausted — admission control, not the
        pool, decides what to do about that.
    max_seq:
        Rows per slot (the longest prefix a request may accumulate).
    specs:
        Named per-row buffer shapes, e.g. ``{"k": (n_heads, head_dim),
        "v": (n_heads, head_dim)}``.  Each named buffer is one
        ``[n_slots, max_seq, *spec]`` tensor.
    dtype:
        Element dtype of every buffer (default float32).
    device:
        Where the arena lives: the card unless ``"cpu"`` is asked for.
    """

    def __init__(self, n_slots: int, max_seq: int,
                 specs: Mapping[str, tuple[int, ...]],
                 dtype: torch.dtype = torch.float32, device: Any = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1 (got {n_slots})")
        if max_seq < 1:
            raise ValueError(f"max_seq must be >= 1 (got {max_seq})")
        if not specs:
            raise ValueError("specs must name at least one buffer")
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.specs = {str(k): tuple(int(d) for d in v)
                      for k, v in specs.items()}
        self.dtype = dtype
        self.device = resolve_device(device)
        self._buf = {k: torch.zeros((self.n_slots, self.max_seq) + shp,
                                    dtype=dtype, device=self.device)
                     for k, shp in self.specs.items()}
        self._len = [0] * self.n_slots
        self._live = [False] * self.n_slots
        self._free: list[int] = list(range(self.n_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self.allocs = 0
        self.frees = 0
        self.high_water = 0

    # -- lifecycle ----------------------------------------------------------- #
    def alloc(self) -> int:
        """Claim a free slot (length reset to 0).  Never returns a slot
        that is already live — aliasing a live request's cache is the one
        unrecoverable serving bug, so exhaustion raises instead."""
        with self._lock:
            if not self._free:
                raise SlotError(
                    f"slot pool exhausted ({self.n_slots} live); free a "
                    "retired request's slot before admitting another")
            s = self._free.pop()
            if self._live[s]:  # free-list corruption — fail loudly
                raise SlotError(f"free list returned live slot {s}")
            self._live[s] = True
            self._len[s] = 0
            self.allocs += 1
            self.high_water = max(self.high_water, self.live_count())
            return s

    def free(self, slot: int) -> None:
        """Release a live slot.  Slot ``-1`` (dead row) is a no-op;
        freeing a non-live slot raises (double-free guard)."""
        if slot < 0:
            return
        with self._lock:
            if not (0 <= slot < self.n_slots) or not self._live[slot]:
                raise SlotError(f"free of non-live slot {slot}")
            self._live[slot] = False
            self._len[slot] = 0
            self._free.append(slot)
            self.frees += 1

    # -- per-step access ------------------------------------------------------ #
    def append(self, slot: int, **rows: Any) -> int:
        """Write one row per named buffer at the slot's current length and
        advance it; returns the row index written.  Slot ``-1`` discards
        (returns -1); appending to a freed slot raises (use-after-free)."""
        if slot < 0:
            return -1
        extra = set(rows) - set(self._buf)
        if extra or set(self._buf) - set(rows):
            raise SlotError(
                f"append must write every buffer {sorted(self._buf)} "
                f"(got {sorted(rows)})")
        with self._lock:
            if not (0 <= slot < self.n_slots) or not self._live[slot]:
                raise SlotError(f"append to non-live slot {slot} "
                                "(use-after-free?)")
            pos = self._len[slot]
            if pos >= self.max_seq:
                raise SlotError(
                    f"slot {slot} full ({self.max_seq} rows)")
            for k, v in rows.items():
                self._buf[k][slot, pos] = torch.as_tensor(
                    v, dtype=self.dtype, device=self.device)
            self._len[slot] = pos + 1
            return pos

    def read(self, slot: int) -> dict[str, torch.Tensor]:
        """Copies of the slot's filled rows per buffer ([len, *spec]).
        Slot ``-1`` reads as empty ([0, *spec]) so dead rows attend over
        nothing without a special case in the caller."""
        with self._lock:
            if slot < 0:
                return {k: torch.zeros((0,) + shp, dtype=self.dtype,
                                       device=self.device)
                        for k, shp in self.specs.items()}
            if not (0 <= slot < self.n_slots) or not self._live[slot]:
                raise SlotError(f"read of non-live slot {slot}")
            n = self._len[slot]
            return {k: b[slot, :n].clone() for k, b in self._buf.items()}

    def length(self, slot: int) -> int:
        """Filled rows of a slot (0 for the dead row) — the decode step's
        absolute position, e.g. the RoPE offset."""
        if slot < 0:
            return 0
        with self._lock:
            if not (0 <= slot < self.n_slots) or not self._live[slot]:
                raise SlotError(f"length of non-live slot {slot}")
            return self._len[slot]

    # -- audits --------------------------------------------------------------- #
    def live_count(self) -> int:
        return sum(self._live)

    def live_slots(self) -> list[int]:
        with self._lock:
            return [i for i, v in enumerate(self._live) if v]

    def check_no_leaks(self, expected_live: Iterable[int] = ()) -> None:
        """Raise unless exactly ``expected_live`` slots are live — the
        end-of-run leak audit."""
        with self._lock:
            live = {i for i, v in enumerate(self._live) if v}
        exp = set(expected_live)
        if live != exp:
            raise SlotError(
                f"slot leak audit failed: live={sorted(live)} "
                f"expected={sorted(exp)} (allocs={self.allocs} "
                f"frees={self.frees})")

    def stats(self) -> dict:
        with self._lock:
            return {"n_slots": self.n_slots, "live": sum(self._live),
                    "allocs": self.allocs, "frees": self.frees,
                    "high_water": self.high_water}


class DecodeSession:
    """Context-managed slot lifetime: alloc on enter, free on exit.

    The free runs on ALL exits (normal and exception), so driver loops
    that die mid-request still return the slot.
    """

    def __init__(self, pool: KVSlotPool):
        self.pool = pool
        self.slot: int | None = None

    def __enter__(self) -> "DecodeSession":
        self.slot = self.pool.alloc()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self.slot is not None:
            self.pool.free(self.slot)
            self.slot = None
        return False
