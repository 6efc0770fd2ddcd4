"""Cost model — the H100 analog of the paper's processing-time sources.

Courier-FPGA obtains per-function processing times from (a) the Frontend's
runtime profile for software functions and (b) the logic-synthesis tool's
latency report for hardware modules (paper Sect. III-B.4).  The port has no
synthesis report either, so the "hardware" estimate is an analytical
roofline:

    t = max(bf16 flops / PEAK_FLOPS_BF16 + f32 flops / PEAK_FLOPS_F32,
            bytes / HBM_BW)  (+ collective term)

against NVIDIA H100 SXM **spec-sheet priors** (not measurements): 989 TFLOP/s
dense bf16 on the tensor cores, 67 TFLOP/s of f32 outside them, 3.35 TB/s
HBM3, 450 GB/s NVLink each way, and 232,448 B of shared memory a block can
opt into.  Work on f32 operands (4-byte elements in the cost helpers below)
is timed at the f32 peak: the port's f32 kernels take no bf16 or TF32
operands, since their tolerance (2e-4 of the largest value) leaves no room.
The JAX package's cost model keeps its single peak, so the two packages'
estimates of f32 work differ by design.  Measured times replace the priors
wherever the Frontend or a profiler supplies one.

Both sources feed the same ``NodeCost`` record so the Pipeline Generator's
balanced partitioning is agnostic to where a time came from — exactly as in
the paper, where measured SW times and estimated HW times mix in one table.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

# ---- NVIDIA H100 SXM priors (data sheet; per card) ------------------------ #
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s per direction
SMEM_BYTES = 232_448            # shared memory one block can opt into
SMEM_PER_SM = 233_472           # the SM's 228 KB carve-out shared by blocks
SM_COUNT = 132
MAX_THREADS_PER_SM = 2048

# Host <-> device staging bandwidth used to charge stage boundaries whose
# producer and consumer sit on different devices — the paper's
# "communication frequency of intermediate data" term (PCIe gen5 x16 prior).
HOST_XFER_BW = 64e9             # bytes/s

# The fused stencil kernels' 2-D output tile and its halo (rows and columns
# of neighbours a 3x3 Sobel plus a box filter of up to 3 reaches).  The
# fusion gate and the verifier's shared-memory rule reckon one such tile per
# value a fused run touches; ``kernels.harris.fused_tile`` picks this tile at
# the paper's 1080x1920 frame on the H100.
FUSED_TILE = (16, 64)
FUSED_HALO = 4


# --------------------------------------------------------------------------- #
# Device classes — per-device-class roofline constants
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DeviceClass:
    """Roofline constants for one class of placeable device.

    The paper costs a hardware module against the synthesis report of the
    *target FPGA part*; here every :class:`~repro_torch.core.placement.
    DeviceSpec` maps to a class so a replica assigned to device ``k`` is
    costed against that device's constants (a CPU-class replica of the same
    stage is much slower, and the planner should know).
    """

    name: str
    peak_flops: float = PEAK_FLOPS_BF16
    peak_flops_f32: float = PEAK_FLOPS_F32
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW
    xfer_bw: float = HOST_XFER_BW       # host<->device staging bandwidth
    smem_bytes: int = SMEM_BYTES        # per-block fast memory of the class
    smem_per_sm: int = SMEM_PER_SM
    sm_count: int = SM_COUNT


H100 = DeviceClass("h100")

DEVICE_CLASSES: dict[str, DeviceClass] = {
    "h100": H100,
    "gpu": H100,           # the port's CUDA devices are H100s
    # one beefy host core + DDR: the "software filter on a CPU core" class
    "cpu": DeviceClass("cpu", peak_flops=1e11, peak_flops_f32=1e11,
                       hbm_bw=3e10, link_bw=1e10, xfer_bw=30e9,
                       smem_bytes=32 * 1024**2, smem_per_sm=32 * 1024**2,
                       sm_count=1),
}


def device_class(platform: str) -> DeviceClass:
    """Roofline constants for a platform name (unknown → H100 priors)."""
    return DEVICE_CLASSES.get(str(platform).lower(), H100)


def transfer_ms(nbytes: float, bw_bytes_per_s: float = HOST_XFER_BW) -> float:
    """Wall ms to move ``nbytes`` across a stage boundary that changes
    device — one staging hop at the slower side's transfer bandwidth."""
    if nbytes <= 0:
        return 0.0
    if bw_bytes_per_s <= 0:
        raise ValueError(f"transfer bandwidth must be > 0 "
                         f"(got {bw_bytes_per_s})")
    return 1e3 * float(nbytes) / float(bw_bytes_per_s)


@dataclass
class NodeCost:
    """Roofline terms for one IR node (or one compiled step).

    ``f32_flops`` is the part of ``flops`` done on f32 operands, timed at
    the device's f32 peak; the rest is timed at its bf16 peak.  Costs that
    are summed sum it too."""

    flops: float = 0.0
    bytes_rw: float = 0.0            # HBM traffic (read+write)
    coll_bytes: float = 0.0          # inter-card bytes over NVLink
    measured_ms: float | None = None  # Frontend profile, wins when present
    f32_flops: float = 0.0           # of ``flops``: on f32 operands

    def time_ms(self, chips: int = 1, links: int = 1,
                device: DeviceClass = H100) -> float:
        """Roofline time against ``device`` (H100 priors by default);
        measured times still win — a profile is of the device that ran it."""
        if self.measured_ms is not None:
            return self.measured_ms
        t_compute = ((self.flops - self.f32_flops) / device.peak_flops
                     + self.f32_flops / device.peak_flops_f32) / chips
        t_memory = self.bytes_rw / (chips * device.hbm_bw)
        t_coll = self.coll_bytes / (chips * links * device.link_bw)
        return 1e3 * (max(t_compute, t_memory) + t_coll)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_rw, 1.0)

    def dominant(self, device: DeviceClass = H100) -> str:
        """Which roofline term bounds this cost on ``device``: "compute",
        "memory" or "collective" (compute timed per type, as
        :meth:`time_ms` does)."""
        t_c = ((self.flops - self.f32_flops) / device.peak_flops
               + self.f32_flops / device.peak_flops_f32)
        t_m = self.bytes_rw / device.hbm_bw
        t_x = self.coll_bytes / device.link_bw
        return ("compute", "memory", "collective")[
            int(np.argmax([t_c, t_m, t_x]))]


# --------------------------------------------------------------------------- #
# Fusion model — shared-memory-resident intermediates
# --------------------------------------------------------------------------- #
@dataclass
class FusionEstimate:
    """Predicted economics of fusing a run of adjacent nodes into one kernel.

    On the paper's FPGA the fused cvtColor+cornerHarris module was *slower*
    than its pipelined parts, so Courier rejected it.  On the H100 a fused
    kernel keeps the intermediates in one block's shared memory, so their
    HBM write+readback traffic disappears — but only while the block's tile
    set fits the shared memory a block can have.
    """

    cost: NodeCost                  # the fused kernel's roofline record
    hbm_bytes_saved: float          # intermediate write+read traffic removed
    smem_required: int              # one block's tile set (tiles + halos)
    smem_bytes: int                 # capacity it was checked against
    unfused_ms: float               # sum of the parts' times (seq. latency)

    @property
    def fits_smem(self) -> bool:
        return self.smem_required <= self.smem_bytes

    @property
    def fused_ms(self) -> float:
        """Predicted fused-kernel time; +inf when the tile set spills, so a
        spilling fusion loses against any acceptance threshold."""
        if not self.fits_smem:
            return float("inf")
        return self.cost.time_ms()

    @property
    def wins(self) -> bool:
        return self.fits_smem and self.fused_ms < self.unfused_ms


def fused_cost(parts: "list[NodeCost]", intermediate_bytes: float, *,
               smem_required: int = 0,
               smem_bytes: int = SMEM_BYTES) -> FusionEstimate:
    """Model a fused kernel over ``parts`` with on-chip intermediates.

    ``intermediate_bytes`` is the total size of the values flowing *between*
    the fused parts.  Unfused, each such value costs one HBM write and one
    HBM read; fused, it never leaves the block, so ``2 * intermediate_bytes``
    of traffic vanishes.  FLOPs are conserved.

    ``smem_required`` is one block's resident tile set; above ``smem_bytes``
    the estimate reports ``fused_ms = inf`` so callers reject it.  The parts'
    ``measured_ms`` make up ``unfused_ms`` only: the fused kernel is new
    code, so only the roofline speaks for it.  Their ``f32_flops`` sum into
    the fused cost, which is timed at the f32 peak for that share.
    """
    if not parts:
        raise ValueError("fused_cost needs at least one part")
    flops = sum(p.flops for p in parts)
    byts = sum(p.bytes_rw for p in parts)
    coll = sum(p.coll_bytes for p in parts)
    saved = min(2.0 * intermediate_bytes, byts)     # can't save more than all
    cost = NodeCost(flops=flops, bytes_rw=byts - saved, coll_bytes=coll,
                    f32_flops=sum(p.f32_flops for p in parts))
    unfused_ms = sum(p.time_ms() for p in parts)
    return FusionEstimate(cost=cost, hbm_bytes_saved=saved,
                          smem_required=int(smem_required),
                          smem_bytes=int(smem_bytes), unfused_ms=unfused_ms)


# --------------------------------------------------------------------------- #
# Analytical costs for common op families
# --------------------------------------------------------------------------- #
def matmul_cost(m: int, n: int, k: int, bytes_per_el: int = 2,
                batch: int = 1) -> NodeCost:
    """An [m, k] @ [k, n] product (``batch`` of them): 2mnk flops, each
    operand read once and the result written once; f32 flops when the
    elements take 4 bytes."""
    flops = 2.0 * batch * m * n * k
    byts = bytes_per_el * batch * (m * k + k * n + m * n)
    return NodeCost(flops=flops, bytes_rw=byts,
                    f32_flops=flops if bytes_per_el == 4 else 0.0)


def elementwise_cost(numel: int, flops_per_el: float = 1.0,
                     bytes_per_el: int = 2, n_operands: int = 2) -> NodeCost:
    flops = flops_per_el * numel
    return NodeCost(flops=flops, bytes_rw=bytes_per_el * numel * n_operands,
                    f32_flops=flops if bytes_per_el == 4 else 0.0)


def stencil_cost(h: int, w: int, c: int, taps: int,
                 bytes_per_el: int = 4) -> NodeCost:
    """k-tap 2-D stencil (Sobel, box filter ...) — the Harris building block."""
    numel = h * w * c
    flops = 2.0 * taps * numel
    return NodeCost(flops=flops, bytes_rw=2.0 * bytes_per_el * numel,
                    f32_flops=flops if bytes_per_el == 4 else 0.0)


def attention_cost(batch: int, q_len: int, kv_len: int, heads: int,
                   head_dim: int, kv_heads: int | None = None,
                   window: int | None = None,
                   bytes_per_el: int = 2) -> NodeCost:
    """QK^T + softmax + PV cost; a sliding window caps kv_len at window."""
    kv_heads = kv_heads or heads
    eff_kv = min(kv_len, window) if window else kv_len
    flops = 2.0 * batch * heads * q_len * eff_kv * head_dim * 2  # QK^T and PV
    flops += 5.0 * batch * heads * q_len * eff_kv                # softmax-ish
    byts = bytes_per_el * batch * (
        heads * q_len * head_dim                      # Q
        + 2 * kv_heads * eff_kv * head_dim            # K, V
        + heads * q_len * head_dim)                   # out
    return NodeCost(flops=flops, bytes_rw=byts,
                    f32_flops=flops if bytes_per_el == 4 else 0.0)


# --------------------------------------------------------------------------- #
# Stage replication (TBB parallel filters — widen instead of re-balance)
# --------------------------------------------------------------------------- #
def replicated_bottleneck_ms(stage_ms: "Sequence[float]",
                             replicas: "Sequence[int]",
                             speeds: "Sequence[Sequence[float]] | None" = None,
                             ) -> float:
    """Predicted steady-state token period of a replicated pipeline plan.

    A stage with one-worker service time ``t`` and ``r`` parallel workers
    retires a token every ``t / r`` ms once saturated, so the period is
    ``max_k t_k / r_k``.  ``speeds`` optionally carries one relative
    throughput per replica per stage: stage ``k``'s period is then
    ``t_k / sum_j speed_kj``; an empty entry means homogeneous at speed 1.
    """
    if len(stage_ms) != len(replicas):
        raise ValueError(f"{len(stage_ms)} stage times vs "
                         f"{len(replicas)} replica counts")
    if speeds is not None and len(speeds) != len(stage_ms):
        raise ValueError(f"{len(stage_ms)} stage times vs "
                         f"{len(speeds)} speed vectors")
    period = 0.0
    for k, (t, r) in enumerate(zip(stage_ms, replicas)):
        r = max(int(r), 1)
        sp = list(speeds[k]) if speeds is not None and speeds[k] else None
        if sp is not None:
            if len(sp) != r:
                raise ValueError(f"stage {k}: {len(sp)} replica speeds "
                                 f"for {r} replicas")
            if any(s <= 0 for s in sp):
                raise ValueError(f"stage {k}: replica speeds must be > 0")
            rate = sum(sp)
        else:
            rate = float(r)
        period = max(period, float(t) / rate)
    return period


# --------------------------------------------------------------------------- #
# Measured vs modeled (the online-profile write-back contract)
# --------------------------------------------------------------------------- #
PROFILE_MARGIN = 1.5      # default measured-vs-model contradiction factor


def measured_contradicts(model_ms: float | None, measured_ms: float | None,
                         margin: float = PROFILE_MARGIN) -> bool:
    """True when a measurement deviates from the model by ``margin``x.

    The re-planner's trigger condition: a measured stage/node time that is
    ``>= margin`` times the estimate (or ``<= 1/margin`` of it) means the
    cost table the current plan was balanced on is wrong, so fuse/no-fuse
    and stage-boundary decisions deserve a revisit.  ``None`` on either
    side never contradicts (nothing measured, or nothing modeled).
    """
    if model_ms is None or measured_ms is None:
        return False
    if margin < 1.0:
        raise ValueError(f"margin must be >= 1.0 (got {margin})")
    if model_ms <= 0.0:
        return measured_ms > 0.0
    ratio = measured_ms / model_ms
    return ratio >= margin or ratio <= 1.0 / margin


# --------------------------------------------------------------------------- #
# Measured profiles (the Frontend's profile log)
# --------------------------------------------------------------------------- #
def synchronize(out) -> None:
    """Wait for the card when any tensor in ``out`` lives on it: PyTorch
    returns before a CUDA launch finishes, so a host clock around an
    unsynchronised call measures the enqueue only."""
    import torch

    from .ir import flatten
    devices = {t.device for t in flatten(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def measure_ms(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Wall-clock a callable, synchronising CUDA after every call."""
    def _run():
        synchronize(fn(*args))

    for _ in range(warmup):
        _run()
    t0 = time.perf_counter()
    for _ in range(iters):
        _run()
    return (time.perf_counter() - t0) / iters * 1e3


@dataclass
class CostModel:
    """Per-fn_key cost providers; mixes measured and analytical sources.

    ``measured`` holds per-function EMA wall times fed by the online
    profiler (:meth:`observe`); they supersede the analytical providers
    during :meth:`annotate` — the paper's rule that a runtime profile
    outranks a synthesis-report estimate, kept live while serving.
    """

    chips: int = 1
    links: int = 1
    providers: dict[str, Callable[..., NodeCost]] = field(default_factory=dict)
    measured: dict[str, float] = field(default_factory=dict)
    measure_alpha: float = 0.25

    def register(self, fn_key: str, provider: Callable[..., NodeCost]) -> None:
        self.providers[fn_key] = provider

    def observe(self, fn_key: str, ms: float) -> float:
        """Fold one measured wall time into the per-function EMA."""
        prev = self.measured.get(fn_key)
        a = self.measure_alpha
        self.measured[fn_key] = float(ms) if prev is None \
            else (1.0 - a) * prev + a * float(ms)
        return self.measured[fn_key]

    def annotate(self, ir) -> None:
        """Fill Node.flops / bytes from providers when a node has no profile;
        measured times win and mark the node ``time_source="profile"``."""
        for n in ir.nodes:
            if n.fn_key in self.providers:
                shapes = [ir.values[i].shape for i in n.inputs]
                dtypes = [ir.values[i].dtype for i in n.inputs]
                try:
                    c = self.providers[n.fn_key](shapes, dtypes, n.params)
                except TypeError:
                    continue
                n.flops, n.bytes_rw = c.flops, c.bytes_rw
                if n.time_ms is None:
                    n.time_ms = c.time_ms(self.chips, self.links)
            m = self.measured.get(n.fn_key)
            if m is not None:
                n.time_ms = m
                n.time_source = "profile"
