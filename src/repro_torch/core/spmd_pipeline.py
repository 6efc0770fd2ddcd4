"""SPMD token pipeline — the paper's TBB pipeline across ranks, the port of
the JAX package's ``core/spmd_pipeline.py`` on ``torch.distributed``.

Courier-FPGA's deployed artifact is a token-based software pipeline: each
stage (a group of functions) processes token k while the stage before it
already works on token k+1, the data moving through external memory.
Across ranks (:func:`repro_torch.launch.mesh.run_on_local_mesh`):

    token            = microbatch
    pipeline stage   = a contiguous group of model layers (Courier partition)
    TBB thread pool  = the ranks along the mesh's ``stage`` axis
    DDR3 hand-off    = a send to stage + 1 and a receive from stage - 1
                       (pinned host memory when the ranks share a card)
    token pool       = the microbatches in flight (fill / drain)

The stage boundaries come from the same partitioners (paper policy,
optimal DP) that cut the host pipeline, and stages may hold unequal layer
counts: a stage's stack is padded to the longest and its padding layers
never run.

The schedule is JAX's: T = M + S - 1 steps; at step t stage 0 admits token
t and the last stage retires token t - (S - 1).  A stage computes only in
the steps where it holds a token (t - stage in [0, M)); in its bubble
steps it neither computes nor sends, and its neighbour, on the same
schedule, does not wait for it.  The outputs and gradients are those of
JAX's schedule, which computes there and throws the result away.

The pipeline is differentiable: the hand-off is a
``torch.autograd.Function`` whose backward is the reverse permutation (the
transpose of JAX's ``ppermute``).  Each step's hand-off also passes on an
empty token tensor, so every rank's backward visits the hand-offs in the
reverse of their order, each pairing its receive with its neighbour's
send.  JAX has one controller and torch one a rank: every rank of
:func:`pipeline_microbatches` returns the outputs, and the gradient of a
loss computed alike on every rank is taken from the last stage's own copy
only, so it is JAX's and not S times it.

The collectives (:func:`all_reduce_sum`, :func:`all_gather_cat`) and the
DTensor helpers (:func:`local_bounds`, :func:`unbind_layers`,
:func:`group_transport`) also serve the tensor-parallel layers of
:mod:`repro_torch.models.layers`.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .tree import flatten, leaves, tree_map, unflatten

__all__ = ["stack_stage_params", "stage_apply", "spmd_pipeline_fn",
           "pipeline_microbatches", "all_reduce_sum", "all_gather_cat",
           "is_dtensor", "shard_bounds", "local_bounds", "unbind_layers",
           "group_transport"]


# --------------------------------------------------------------------------- #
# Parameter staging
# --------------------------------------------------------------------------- #
def stack_stage_params(layer_params: Any, boundaries: Sequence[int]
                       ) -> tuple[Any, torch.Tensor]:
    """[L, ...] layer-stacked params → ([S, Lmax, ...] padded, lengths[S]).

    ``boundaries`` are stage start indices, e.g. [0, 3, 8] for L=10 gives
    stages of 3, 5 and 2 layers.  Padding layers are zeros and are skipped
    at run time by the lengths.
    """
    bounds = [int(b) for b in boundaries]
    L = leaves(layer_params)[0].shape[0]
    if bounds[0] != 0:
        raise ValueError("boundaries must start at 0")
    ends = bounds[1:] + [L]
    lengths = [e - b for b, e in zip(bounds, ends)]
    if min(lengths) <= 0:
        raise ValueError(f"empty stage in boundaries {bounds} for L={L}")
    lmax = max(lengths)

    def stack(x: torch.Tensor) -> torch.Tensor:
        segs = []
        for b, e in zip(bounds, ends):
            seg = x[b:e]
            if e - b < lmax:
                seg = torch.cat([seg, x.new_zeros((lmax - (e - b),)
                                                  + tuple(x.shape[1:]))])
            segs.append(seg)
        return torch.stack(segs)            # [S, Lmax, ...]

    return (tree_map(stack, layer_params),
            torch.tensor(lengths, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# One stage = its layers in order, the padding skipped
# --------------------------------------------------------------------------- #
def _layers(stage_params: Any, length) -> list:
    """The first ``length`` layers of a padded [Lmax, ...] stack, one
    ``unbind`` a leaf (so autograd stacks a leaf's layer gradients once)."""
    flat, treedef = flatten(stage_params)
    cols = [a.unbind(0) for a in flat]
    n = min(int(length), len(cols[0]))
    return [unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


def stage_apply(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                stage_params: Any, length, x: torch.Tensor) -> torch.Tensor:
    """Apply the first ``length`` layers of the padded [Lmax, ...] stack to
    x; the padding layers do not run."""
    for lp in _layers(stage_params, length):
        x = block_fn(lp, x)
    return x


# --------------------------------------------------------------------------- #
# Moving tensors between ranks, by transport
# --------------------------------------------------------------------------- #
def _to_wire(t: torch.Tensor, transport: str) -> torch.Tensor:
    """What a rank sends: the tensor itself over NCCL, its raw bytes over
    gloo (exact for every type gloo lacks, bf16 among them), staged in
    pinned host memory when the ranks share a card."""
    t = t.contiguous()
    if transport == "nccl":
        return t
    raw = t.reshape(-1).view(torch.uint8)
    if transport == "gloo":
        return raw
    host = torch.empty(raw.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(raw)
    return host


def _wire_empty(like: torch.Tensor, transport: str) -> torch.Tensor:
    if transport == "nccl":
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    return torch.empty(like.numel() * like.element_size(), dtype=torch.uint8,
                       pin_memory=transport == "gloo+pinned")


def _from_wire(w: torch.Tensor, like: torch.Tensor,
               transport: str) -> torch.Tensor:
    if transport == "nccl":
        return w
    return w.view(like.dtype).view(like.shape).to(like.device)


class _Link:
    """One rank's place on a pipeline axis: the axis group, its global
    ranks in stage order, the transport, and the hand-off clock."""

    def __init__(self, mesh, axis: str, stats: dict | None):
        self.stage = mesh.axis_index(axis)
        self.group, self.line = mesh.axis_group(axis)
        self.transport = mesh.transport
        self.stats = stats

    def join(self, device) -> None:
        """Every rank of the axis meets once before the first hand-off:
        NCCL requires all ranks of a group in its first point-to-point
        batch, and a stage's first step sends or receives with one
        neighbour only."""
        dev = device if self.transport == "nccl" else "cpu"
        dist.all_reduce(torch.zeros(1, device=dev), group=self.group)

    def exchange(self, send: torch.Tensor | None, to: int | None,
                 like: torch.Tensor | None, frm: int | None):
        """Send ``send`` to stage ``to`` and receive a tensor like ``like``
        from stage ``frm`` in one batch (no pair deadlocks); → the received
        tensor or None."""
        t0 = time.perf_counter()
        ops, buf = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, _to_wire(send, self.transport),
                                  self.line[to], self.group))
        if like is not None:
            buf = _wire_empty(like, self.transport)
            ops.append(dist.P2POp(dist.irecv, buf, self.line[frm],
                                  self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        out = None if buf is None else _from_wire(buf, like, self.transport)
        if self.stats is not None:
            if out is not None and out.is_cuda:
                torch.cuda.synchronize(out.device)
            self.stats["handoff_ms"] += 1e3 * (time.perf_counter() - t0)
        return out


class _HandOff(torch.autograd.Function):
    """Forward: send ``y`` to stage + 1 (when given) and receive the next
    step's input from stage - 1 (when ``like`` is given).  Backward: the
    reverse permutation — the received tensor's gradient goes back to
    stage - 1, ``y``'s comes from stage + 1.  ``token`` orders the
    hand-offs of a rank; the new one is returned beside the received
    tensor (empty when nothing was received)."""

    @staticmethod
    def forward(ctx, y, token, link: _Link, like):
        s = link.stage
        ctx.link, ctx.sent, ctx.got = link, y is not None, like is not None
        ctx.y_like = y.detach() if y is not None else None
        got = link.exchange(y, s + 1 if y is not None else None,
                            like, s - 1 if like is not None else None)
        if got is None:
            got = token.new_empty(0)
        return got, token.new_empty(0)

    @staticmethod
    def backward(ctx, g_got, g_token):
        link, s = ctx.link, ctx.link.stage
        g_y = link.exchange(g_got if ctx.got else None,
                            s - 1 if ctx.got else None,
                            ctx.y_like if ctx.sent else None,
                            s + 1 if ctx.sent else None)
        return g_y, torch.zeros_like(g_token), None, None


class _FromLast(torch.autograd.Function):
    """Every rank of the axis gets the last stage's tensor; the gradient
    is the last stage's own (the others' copies take none)."""

    @staticmethod
    def forward(ctx, out, link: _Link):
        last = len(link.line) - 1
        ctx.mine = link.stage == last
        w = (_to_wire(out, link.transport) if ctx.mine
             else _wire_empty(out, link.transport))
        dist.broadcast(w, src=link.line[last], group=link.group)
        return out.clone() if ctx.mine else _from_wire(w, out, link.transport)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None


def all_reduce_sum(t: torch.Tensor, group, transport: str) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, a new tensor like ``t``:
    NCCL sums on the card in ``t``'s type; gloo (which takes no CUDA
    tensor and lacks bf16 sums) sums in f32 on the host, staged in pinned
    host memory when the ranks share a card.  On an H100 shared by 2
    ranks, gathering the f32 partials instead and adding them on the card
    took 1.5-1.8x the host add's time."""
    if transport == "nccl":
        t = t.contiguous().clone()
        dist.all_reduce(t, group=group)
        return t
    f = torch.empty(t.shape, dtype=torch.float32,
                    pin_memory=transport == "gloo+pinned")
    f.copy_(t)
    dist.all_reduce(f, group=group)
    return f.to(device=t.device, dtype=t.dtype)


def all_gather_cat(t: torch.Tensor, dim: int, group,
                   transport: str) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in
    group-rank order: this rank's ``t`` itself, the others' received
    (exact: gloo moves raw bytes, through pinned host memory when the
    ranks share a card)."""
    ws = [_wire_empty(t, transport)
          for _ in range(dist.get_world_size(group))]
    dist.all_gather(ws, _to_wire(t, transport), group=group)
    me = dist.get_rank(group)
    return torch.cat([t if i == me else _from_wire(w, t, transport)
                      for i, w in enumerate(ws)], dim=dim)


# --------------------------------------------------------------------------- #
# DTensor shards (the tensor-parallel layers of repro_torch.models.layers)
# --------------------------------------------------------------------------- #
def is_dtensor(x) -> bool:
    """``x`` is a DTensor (none can exist before DTensor's module is
    imported, so a process that never shards does not import it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard_bounds(device_mesh, placements, shape) -> tuple:
    """The slice of each dim of a ``shape`` tensor that this rank's shard
    covers under ``placements`` on ``device_mesh`` (a dim sharded over
    several mesh dims is split by the outermost first, as DTensor splits
    it; the whole dim where it is not sharded)."""
    coord = device_mesh.get_coordinate()
    out = [slice(0, n) for n in shape]
    for m, pl in enumerate(placements):
        if pl.is_shard():
            d = pl.dim
            step = (out[d].stop - out[d].start) // device_mesh.size(m)
            lo = out[d].start + coord[m] * step
            out[d] = slice(lo, lo + step)
    return tuple(out)


def local_bounds(x) -> tuple:
    """:func:`shard_bounds` of DTensor ``x``'s local tensor; the whole of
    each dim for a plain tensor (one process holds it whole)."""
    if not is_dtensor(x):
        return tuple(slice(0, n) for n in x.shape)
    return shard_bounds(x.device_mesh, x.placements, x.shape)


def unbind_layers(x) -> list:
    """A stacked ``[L, ...]`` DTensor (its layer dim not sharded) as L
    DTensors, views of its local tensor: no communication, and an in-place
    write to a layer lands in the stack."""
    from torch.distributed.tensor import DTensor, Shard

    if any(pl.is_shard(0) for pl in x.placements):
        raise ValueError(f"the layer dim of {x.placements} is sharded")
    pls = tuple(Shard(pl.dim - 1) if pl.is_shard() else pl
                for pl in x.placements)
    shape, stride = x.shape[1:], x.stride()[1:]
    return [DTensor.from_local(t, x.device_mesh, pls, run_check=False,
                               shape=shape, stride=stride)
            for t in x.to_local().unbind(0)]


def group_transport(group, device) -> str:
    """The transport that a process group and a tensor's device imply (as
    :func:`repro_torch.launch.mesh.choose_transport` picks it): ``nccl``
    for an NCCL group, ``gloo+pinned`` for a gloo group moving CUDA
    tensors (ranks sharing a card), ``gloo`` on the CPU."""
    if dist.get_backend(group) == "nccl":
        return "nccl"
    return "gloo+pinned" if torch.device(device).type == "cuda" else "gloo"


class _SumGrads(torch.autograd.Function):
    """Identity over a rank's copy of replicated leaves; their gradients
    summed over ``groups`` (each rank's stage reads its own slice, so the
    sum is the whole gradient — JAX's transpose of a replicated input)."""

    @staticmethod
    def forward(ctx, groups, transport, *xs):
        ctx.groups, ctx.transport = groups, transport
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            for group in ctx.groups:
                g = all_reduce_sum(g, group, ctx.transport)
            out.append(g)
        return (None, None, *out)


class _GatherBatch(torch.autograd.Function):
    """All-gather of the batch shards along dim 1; the backward takes this
    rank's own slice of the gradient."""

    @staticmethod
    def forward(ctx, local, group, rank_pos, transport):
        ctx.pos, ctx.n = rank_pos, local.shape[1]
        return all_gather_cat(local, 1, group, transport)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.pos * ctx.n
        return g[:, lo:lo + ctx.n].contiguous(), None, None, None


# --------------------------------------------------------------------------- #
# The pipeline step loop (runs in every rank of the stage axis)
# --------------------------------------------------------------------------- #
def spmd_pipeline_fn(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     n_stages: int, axis_name: str = "stage",
                     stats: dict | None = None) -> Callable:
    """Build ``fn(stage_params, lengths, xs)`` for every rank of a mesh
    (:func:`repro_torch.launch.mesh.run_on_local_mesh`) whose
    ``axis_name`` axis has ``n_stages`` ranks; outside a mesh only
    ``n_stages == 1`` runs.

    Per-rank inputs, as JAX's per-device ones:
      stage_params — this rank's stage stack, leaves [1, Lmax, ...]
      lengths      — [S] per-stage layer counts
      xs           — [M, mb, ...] all microbatch tokens (stage 0 reads
                     them; ``block_fn`` keeps their shape and type)

    Returns out_buf [M, mb, ...]: the last stage's holds the pipeline
    outputs, the others' are zeros (use :func:`pipeline_microbatches` for
    the outputs on every rank).  ``stats``, when given, receives this
    rank's ``stage``, ``layers``, ``compute_ms`` (its blocks, the card
    synchronised around them), ``handoff_ms``, ``wall_ms`` and
    ``busy_share``.
    """

    def fn(stage_params, lengths, xs):
        from ..launch.mesh import current_mesh

        mesh = current_mesh()
        if mesh is None:
            if n_stages != 1:
                raise RuntimeError(f"a {n_stages}-stage pipeline runs in the "
                                   f"ranks of run_on_local_mesh")
            link, stage = None, 0
        else:
            if mesh.shape[axis_name] != n_stages:
                raise ValueError(f"{n_stages} stages on a "
                                 f"{mesh.shape[axis_name]}-way "
                                 f"'{axis_name}' axis")
            if stats is not None:
                stats.update(handoff_ms=0.0)
            link = _Link(mesh, axis_name, stats)
            link.join(xs.device)
            stage = link.stage
        my_len = int(lengths[stage])
        layers = _layers(tree_map(lambda a: a[0], stage_params), my_len)
        M, S = xs.shape[0], n_stages
        T = M + S - 1
        sync = (torch.cuda.synchronize if stats is not None and xs.is_cuda
                else lambda *a: None)
        token = torch.zeros(0, device=xs.device,
                            requires_grad=torch.is_grad_enabled())
        outs, recv, compute_ms = [], None, 0.0
        sync()
        t_start = time.perf_counter()
        for t in range(T):
            y = None
            if 0 <= t - stage < M:                 # this stage holds a token
                x = xs[t] if stage == 0 else recv
                t0 = time.perf_counter()
                y = x
                for lp in layers:
                    y = block_fn(lp, y)
                sync()
                compute_ms += 1e3 * (time.perf_counter() - t0)
                if stage == S - 1:
                    outs.append(y)                 # retires token t - (S-1)
            if S > 1:
                send = y if stage < S - 1 else None
                wants = stage > 0 and 0 <= t + 1 - stage < M
                recv, token = _HandOff.apply(send, token, link,
                                             xs[0] if wants else None)
        out = torch.stack(outs) if stage == S - 1 else torch.zeros_like(xs)
        if token.requires_grad:                    # every rank's backward
            out = out + token.sum().to(out.dtype)  # walks the hand-offs
        if stats is not None:
            wall = 1e3 * (time.perf_counter() - t_start)
            stats.update(stage=stage, layers=my_len, compute_ms=compute_ms,
                         wall_ms=wall, busy_share=compute_ms / wall)
        return out

    return fn


# --------------------------------------------------------------------------- #
# Mesh-level convenience wrapper
# --------------------------------------------------------------------------- #
def pipeline_microbatches(mesh, block_fn: Callable, layer_params: Any,
                          boundaries: Sequence[int], xs: torch.Tensor,
                          axis_name: str = "stage",
                          batch_axis: str | None = None,
                          stats: dict | None = None) -> torch.Tensor:
    """Run [M, mb, ...] microbatches through the staged pipeline; called in
    every rank with the rank's :class:`~repro_torch.launch.mesh.RankMesh`.

    ``layer_params`` leaves are [L, ...], the same on every rank;
    ``boundaries`` come from a PipelinePlan (stage start layer indices).
    Every rank returns the [M, mb, ...] outputs.  When ``batch_axis`` is
    given, the microbatch dim of ``xs`` is split over it (data parallel x
    pipeline parallel).  The gradient that reaches ``layer_params`` on
    every rank is the whole one: each stage's (and batch shard's) part,
    summed over the ranks.
    """
    n_stages = mesh.shape[axis_name]
    if len(boundaries) != n_stages:
        raise ValueError(f"{len(boundaries)} stage boundaries for "
                         f"{n_stages}-way '{axis_name}' mesh axis")
    staged, lengths = stack_stage_params(layer_params, boundaries)
    axes = [axis_name] + ([batch_axis] if batch_axis else [])
    flat = leaves(staged)
    if torch.is_grad_enabled() and any(a.requires_grad for a in flat):
        summed = iter(_SumGrads.apply(
            [mesh.axis_group(a)[0] for a in axes], mesh.transport, *flat))
        staged = tree_map(lambda _: next(summed), staged)
    stage = mesh.axis_index(axis_name)
    mine = tree_map(lambda a: a[stage:stage + 1], staged)
    if batch_axis:
        group, line = mesh.axis_group(batch_axis)
        pos = mesh.axis_index(batch_axis)
        n = xs.shape[1] // len(line)
        xs = xs[:, pos * n:(pos + 1) * n]
    out = spmd_pipeline_fn(block_fn, n_stages, axis_name, stats)(
        mine, lengths, xs)
    out = _FromLast.apply(out, _Link(mesh, axis_name, None))
    if batch_axis:
        out = _GatherBatch.apply(out, group, pos, mesh.transport)
    return out
