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

The collectives, Megatron's conjugate pairs under autograd
(:func:`all_reduce_sum` and :func:`copy_to_ranks`, :func:`all_gather_cat`
and :func:`own_part`, and for the sequence-parallel carry
:func:`gather_seq` and :func:`reduce_scatter`, all on
:func:`reduce_over_ranks` and :func:`gather_over_ranks`), and the DTensor
helpers (:func:`local_bounds`, :func:`unbind_layers`, :func:`with_spec`,
:func:`group_transport`) also serve the tensor-parallel layers of
:mod:`repro_torch.models.layers`; over a data axis, :func:`unshard`
gathers a weight's storage-only dim (its gradient summed back by
:func:`gather_seq`'s rule), :func:`batch_line` names the line of ranks a
batch is split over (one axis, or ``pod`` and ``data`` together: the
line :func:`axes_group` finds among the rank mesh's groups) and
:func:`batch_like` lays a result out as the batch; a stack whose layer dim
is split over that line unbinds into :class:`HeldBy` records, each layer
held by one rank, which sends the others their rows (:func:`held_rows`).
The rank mesh of a process of
:func:`~repro_torch.launch.mesh.run_on_local_mesh` is registered here
(:func:`current_mesh`), so nothing below the launcher imports it.
"""
from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .tree import flatten, leaves, tree_map, unflatten

__all__ = ["stack_stage_params", "stage_apply", "spmd_pipeline_fn",
           "pipeline_microbatches", "current_mesh", "set_current_mesh",
           "reduce_over_ranks", "gather_over_ranks", "all_reduce_sum",
           "copy_to_ranks", "all_gather_cat", "own_part", "gather_seq",
           "reduce_scatter", "is_dtensor", "local_tensor", "like_dtensor",
           "sharded_dims", "placements", "with_spec", "shard_bounds",
           "local_bounds", "unbind_layers", "HeldBy", "held_rows",
           "group_transport", "unshard", "batch_line", "batch_like",
           "axes_group"]


# --------------------------------------------------------------------------- #
# This process's rank mesh
# --------------------------------------------------------------------------- #
_CURRENT_MESH = None


def current_mesh():
    """The :class:`~repro_torch.launch.mesh.RankMesh` of this process
    inside :func:`~repro_torch.launch.mesh.run_on_local_mesh` (which
    registers it with :func:`set_current_mesh`), else None."""
    return _CURRENT_MESH


def set_current_mesh(mesh) -> None:
    """Register this process's rank mesh (None clears it)."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


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


def reduce_over_ranks(t: torch.Tensor, group, transport: str, *,
                      op: str = "sum", backward: bool = False,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The sum (``op="sum"``) or the max (``op="max"``) of ``t`` over
    ``group``'s ranks, a new tensor like ``t`` (or written into ``out``,
    ``t`` itself allowed, and returned), outside autograd: NCCL reduces on
    the card in ``t``'s type; gloo (which takes no CUDA tensor and lacks
    bf16 sums) in f32 on the host (f64 for an f64 ``t``), staged in pinned
    host memory when the ranks share a card.  On an H100 shared by 2
    ranks, gathering the f32 partials instead and adding them on the card
    took 1.5-1.8x the host add's time.  ``backward`` tells an instrumented
    copy of this function that a backward pass called it; it changes
    nothing here."""
    del backward
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    if transport == "nccl":
        if out is None:
            out = t.contiguous().clone()
        elif out is not t:
            out.copy_(t)
        dist.all_reduce(out, op=rop, group=group)
        return out
    f = torch.empty(t.shape, dtype=torch.float64 if t.dtype == torch.float64
                    else torch.float32, pin_memory=transport == "gloo+pinned")
    f.copy_(t)
    dist.all_reduce(f, op=rop, group=group)
    if out is None:
        return f.to(device=t.device, dtype=t.dtype)
    return out.copy_(f)


def gather_over_ranks(t: torch.Tensor, dim: int, group, transport: str, *,
                      backward: bool = False) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in
    group-rank order, outside autograd: this rank's ``t`` itself, the
    others' received (exact: gloo moves raw bytes, through pinned host
    memory when the ranks share a card).  ``backward`` as in
    :func:`reduce_over_ranks`."""
    del backward
    ws = [_wire_empty(t, transport)
          for _ in range(dist.get_world_size(group))]
    dist.all_gather(ws, _to_wire(t, transport), group=group)
    me = dist.get_rank(group)
    return torch.cat([t if i == me else _from_wire(w, t, transport)
                      for i, w in enumerate(ws)], dim=dim)


def _own(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of ``t`` along ``dim`` (parts in group-rank
    order, as :func:`gather_over_ranks` concatenates them)."""
    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n).contiguous()


# The collectives under autograd, in Megatron's conjugate pairs: each
# function's backward is its partner's forward.  Every backward collective
# comes in the reverse of the forward order on every rank, since the ranks
# build the same graph.
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, transport):
        return reduce_over_ranks(t, group, transport)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, transport):
        ctx.group, ctx.transport = group, transport
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (reduce_over_ranks(g, ctx.group, ctx.transport,
                                  backward=True), None, None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, transport, sum_grad):
        ctx.dim, ctx.group, ctx.transport = dim, group, transport
        ctx.sum_grad = sum_grad
        return gather_over_ranks(t, dim, group, transport)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = reduce_over_ranks(g, ctx.group, ctx.transport, backward=True)
        return _own(g, ctx.dim, ctx.group), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, transport, sum_first):
        ctx.dim, ctx.group, ctx.transport = dim, group, transport
        if sum_first:
            t = reduce_over_ranks(t, group, transport)
        return _own(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (gather_over_ranks(g.contiguous(), ctx.dim, ctx.group,
                                  ctx.transport, backward=True),
                None, None, None, None)


def all_reduce_sum(t: torch.Tensor, group, transport: str) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks (:func:`reduce_over_ranks`);
    the gradient passes as it is (the sum of a row split's partial
    products: every rank's part of the sum takes the whole gradient)."""
    return _AllReduceSum.apply(t, group, transport)


def copy_to_ranks(t: torch.Tensor, group, transport: str) -> torch.Tensor:
    """``t`` itself, whose gradient is summed over ``group``'s ranks: the
    input every rank holds whole as it enters a column split (each rank's
    columns give a part of its gradient).  The transpose of
    :func:`all_reduce_sum`."""
    return _CopyToRanks.apply(t, group, transport)


def all_gather_cat(t: torch.Tensor, dim: int, group,
                   transport: str) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``
    (:func:`gather_over_ranks`); the gradient of the whole is this rank's
    slice of it (every rank holds the whole gradient)."""
    return _Gather.apply(t, dim, group, transport, False)


def own_part(t: torch.Tensor, dim: int, group, transport: str
             ) -> torch.Tensor:
    """This rank's part of ``t``, which every rank holds whole, along
    ``dim``; the gradients of the parts are gathered.  The transpose of
    :func:`all_gather_cat`."""
    return _Split.apply(t, dim, group, transport, False)


def gather_seq(t: torch.Tensor, dim: int, group, transport: str
               ) -> torch.Tensor:
    """The sequence-parallel carry's parts gathered along ``dim`` as it
    enters a column split; each rank's gradient of the whole is a part
    (its columns'), so the gradient is summed over the ranks and this
    rank's slice kept."""
    return _Gather.apply(t, dim, group, transport, True)


def reduce_scatter(t: torch.Tensor, dim: int, group, transport: str
                   ) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of ``t`` over the ranks (a
    row split's partial products, kept as the sequence-parallel carry);
    the gradients of the parts are gathered.  The transpose of
    :func:`gather_seq`.  gloo has no reduce-scatter: the sum is
    :func:`reduce_over_ranks`' (the f32 host add, measured the faster on
    one card), then the slice, so the split carry holds the same bits as
    the whole one; each rank receives m times the bytes it keeps."""
    return _Split.apply(t, dim, group, transport, True)


# --------------------------------------------------------------------------- #
# DTensor shards (the tensor-parallel layers of repro_torch.models.layers)
# --------------------------------------------------------------------------- #
def is_dtensor(x) -> bool:
    """``x`` is a DTensor (none can exist before DTensor's module is
    imported, so a process that never shards does not import it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_tensor(x):
    """A DTensor's local tensor (no communication); a plain tensor as it
    is."""
    return x.to_local() if is_dtensor(x) else x


def like_dtensor(local: torch.Tensor, x):
    """``local`` as a DTensor laid out as DTensor ``x`` (its mesh,
    placements, global shape and stride): this rank's part of a tensor
    shaped like ``x``; no communication.  ``local`` itself when ``x`` is
    a plain tensor."""
    if not is_dtensor(x):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def sharded_dims(x) -> tuple:
    """The mesh dims of more than one rank over which DTensor ``x`` is
    sharded (none for a plain tensor): the ranks along them hold
    different parts of it."""
    if not is_dtensor(x):
        return ()
    return tuple(m for m, pl in enumerate(x.placements)
                 if pl.is_shard() and x.device_mesh.size(m) > 1)


def placements(device_mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh`` (whose dim names
    are the spec's axes): ``Shard(d)`` on every mesh dim named in tensor
    dim d's entry, ``Replicate()`` on the rest.  A dim over two axes
    (``("pod", "data")``) is ``Shard(d)`` on both, split in mesh-dim order,
    as the spec's tuple orders them."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def with_spec(x, spec):
    """``x`` redistributed to ``spec`` when it is a DTensor laid out
    otherwise; a DTensor already in that layout (its placements may differ
    only on mesh dims of one rank) and a plain tensor (held whole by one
    process) unchanged.  Where a dim split over a batch axis (``data`` or
    ``pod``) of more than one rank would have to move, it raises instead:
    DTensor would move it over a gloo group, which has no CUDA all-gather
    and no reduce-scatter, and the layers gather a weight's ``data`` dim
    themselves (:func:`unshard`).  (A replicated dim taking its shard
    there is a local slice.)"""
    if not is_dtensor(x):
        return x
    dm = x.device_mesh
    want = placements(dm, spec)
    moved = [m for m, (a, b) in enumerate(zip(x.placements, want))
             if dm.size(m) > 1 and a != b]
    if not moved:
        return x
    batch = [dm.mesh_dim_names[m] for m in moved
             if dm.mesh_dim_names[m] in ("data", "pod")
             and not x.placements[m].is_replicate()]
    if batch:
        raise NotImplementedError(
            f"with_spec: {tuple(x.placements)} -> {want} moves a batch "
            f"axis {batch}; gather a weight's data dim with unshard, "
            f"never by DTensor.redistribute")
    return x.redistribute(dm, want)


def unshard(x, axis: str, sum_grad: bool):
    """DTensor ``x`` with its shard over mesh axis ``axis`` (of more than
    one rank) gathered: the ranks' local tensors concatenated along the
    sharded dim in group-rank order (:func:`gather_over_ranks`, exact), as
    a DTensor replicated over ``axis`` and laid out as ``x`` on the other
    mesh dims; ``x`` itself where it is not sharded there, and a plain
    tensor unchanged.  The gradient of the whole is summed over the axis in
    f32, rounded once, and this rank's part kept (:func:`gather_seq`) when
    ``sum_grad`` (the ranks' uses are parts: each its own batch rows), else
    this rank's part of it (:func:`all_gather_cat`: each rank's gradient
    is already the whole)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    dm = x.device_mesh
    names = dm.mesh_dim_names
    if axis not in names:
        return x
    m = names.index(axis)
    pl = x.placements[m]
    if not pl.is_shard() or dm.size(m) == 1:
        return x
    if any(q.is_shard(pl.dim) for i, q in enumerate(x.placements)
           if i != m and dm.size(i) > 1):
        raise ValueError(f"unshard: dim {pl.dim} of {tuple(x.placements)} "
                         f"is split over another axis too")
    group = dm.get_group(axis)
    local = x.to_local()
    whole = _Gather.apply(local.contiguous(), pl.dim, group,
                          group_transport(group, local.device), sum_grad)
    pls = list(x.placements)
    pls[m] = Replicate()
    return DTensor.from_local(whole, dm, tuple(pls), run_check=False,
                              shape=x.shape, stride=x.stride())


def axes_group(device_mesh, dims: Sequence[int]):
    """The process group of this rank's line over mesh dims ``dims`` of
    ``device_mesh`` (in mesh order): the mesh's own group for one dim; for
    several (a batch split over ``pod`` and ``data``), the group that
    :func:`~repro_torch.launch.mesh.run_on_local_mesh` made for those axes
    (its rank mesh's ``groups``, keyed by the axis names), whose ranks must
    be the line's, flattened with the outermost dim first (so its group
    ranks run pod-major, as a spec's ``("pod", "data")`` splits a dim).
    Raises where no such group was made."""
    dims = sorted(int(m) for m in dims)
    if len(dims) == 1:
        return device_mesh.get_group(dims[0])
    names = tuple(device_mesh.mesh_dim_names[m] for m in dims)
    coord = device_mesh.get_coordinate()
    at = tuple(slice(None) if m in dims else c for m, c in enumerate(coord))
    ranks = [int(r) for r in device_mesh.mesh[at].reshape(-1)]
    mesh = current_mesh()
    entry = None if mesh is None else mesh.groups.get(names)
    if entry is None or list(entry[1]) != ranks:
        raise NotImplementedError(
            f"no process group of the mesh axes {names} over ranks {ranks}: "
            f"run_on_local_mesh makes the (pod, data) line")
    return entry[0]


def batch_line(x) -> tuple | None:
    """(process group, transport) of the line of ranks over which DTensor
    ``x``'s dim 0, its batch, is split (each rank holding its rows): the
    mesh dims of more than one rank that shard it, one axis or ``pod`` and
    ``data`` together (:func:`axes_group`; group ranks pod-major, as
    :func:`shard_bounds` orders the rows).  None for a plain tensor and a
    batch whole on every rank.  A mesh's other axes (``model``, and
    ``stage``, over which every batch is replicated) are never part of
    the line.  Two lines are the same when their ranks are."""
    if not is_dtensor(x):
        return None
    dm = x.device_mesh
    dims = [m for m, pl in enumerate(x.placements)
            if pl.is_shard(0) and dm.size(m) > 1]
    if not dims:
        return None
    group = axes_group(dm, dims)
    return group, group_transport(group, x.to_local().device)


def batch_like(local: torch.Tensor, x):
    """``local``, this rank's rows of a result, as a DTensor whose dim 0
    is laid out as batch DTensor ``x``'s (its mesh and placements, the
    global batch ``x.shape[0]``); ``local`` itself when ``x`` is a plain
    tensor.  No communication."""
    if not is_dtensor(x):
        return local
    from torch.distributed.tensor import DTensor

    shape = torch.Size((x.shape[0], *local.shape[1:]))
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


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
    each dim for a plain tensor (one process holds it whole); a
    :class:`HeldBy` layer's ``bounds``."""
    if isinstance(x, HeldBy):
        return x.bounds
    if not is_dtensor(x):
        return tuple(slice(0, n) for n in x.shape)
    return shard_bounds(x.device_mesh, x.placements, x.shape)


@dataclass(frozen=True, eq=False)
class HeldBy:
    """A layer of a stacked DTensor whose layer dim is split over the mesh
    axes ``axes`` of more than one rank (the vlm self cache's ``per`` over
    ``data``, or over ``("pod", "data")``, as the JAX rule lays it out):
    one rank of that line, its position ``owner`` (pod-major over
    ``axes``, the line's group rank, :func:`axes_group`), holds the layer
    whole over the line, at ``index`` of its local stack (flattened over
    the stack dims).  ``layer``: on the owner, the layer's DTensor (a view
    of its local stack, replicated over ``axes``); None on the other ranks
    of the line.  ``shape`` and ``dtype``: the layer's; ``bounds``: the
    slice of each dim the owner holds, which is this rank's too on the
    other mesh axes (the ranks of the line share their other coordinates);
    ``device_mesh``, and ``device`` the local tensors'.  Every rank of the
    line gets a record for every layer, so all of them meet at each
    layer's exchange (:func:`held_rows`) in the same order."""

    axes: tuple
    owner: int
    index: int
    layer: Any
    shape: torch.Size
    dtype: torch.dtype
    bounds: tuple
    device_mesh: Any
    device: torch.device

    @property
    def dims(self) -> list:
        """The mesh dims of ``axes``."""
        return [self.device_mesh.mesh_dim_names.index(a) for a in self.axes]

    @property
    def size(self) -> int:
        """The ranks of the line."""
        return math.prod(self.device_mesh.size(m) for m in self.dims)

    @property
    def position(self) -> int:
        """This rank's position on the line (pod-major)."""
        coord = self.device_mesh.get_coordinate()
        pos = 0
        for m in self.dims:
            pos = pos * self.device_mesh.size(m) + coord[m]
        return pos


def unbind_layers(x, dims: int = 1) -> list:
    """A stacked ``[L, ...]`` DTensor (or, ``dims=2``, a ``[G, per, ...]``
    one, in the order g * per + j) as its layers' DTensors, views of its
    local tensor: no communication, and an in-place write to a layer lands
    in the stack.  A stack dim sharded over mesh dims of one rank gives
    layers replicated there.  A stack dim split over mesh axes of more
    than one rank (the vlm self cache's ``per`` over ``data``, or over
    ``pod`` and ``data``: the line's positions pod-major) gives a
    :class:`HeldBy` record for every layer, on every rank: the owner's
    holds its view, and its local index; no layer is copied."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm, pls, split = x.device_mesh, [], []
    for m, pl in enumerate(x.placements):
        if pl.is_shard() and pl.dim < dims:
            if dm.size(m) > 1:
                split.append(m)
            pls.append(Replicate())
        else:
            pls.append(Shard(pl.dim - dims) if pl.is_shard() else pl)
    if len({x.placements[m].dim for m in split}) > 1:
        raise ValueError(f"the layer dims of {x.placements} are split over "
                         f"mesh axes along two stack dims")
    shape, stride = x.shape[dims:], x.stride()[dims:]
    local = x.to_local()
    views = [DTensor.from_local(t, dm, tuple(pls), run_check=False,
                                shape=shape, stride=stride)
             for t in local.flatten(0, dims - 1).unbind(0)]
    if not split:
        return views
    d = x.placements[split[0]].dim
    n = math.prod(dm.size(m) for m in split)
    if x.shape[d] % n:
        raise ValueError(f"stack dim {d} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    axes = tuple(dm.mesh_dim_names[m] for m in split)
    per_rank = x.shape[d] // n
    bounds = shard_bounds(dm, tuple(pls), shape)
    out = []
    for i in range(math.prod(x.shape[:dims])):
        coord, rest = [], i                    # i's stack coordinates
        for size in reversed(x.shape[:dims]):
            rest, c = divmod(rest, size)
            coord.insert(0, c)
        owner, coord[d] = divmod(coord[d], per_rank)
        index = 0
        for c, size in zip(coord, local.shape[:dims]):
            index = index * size + c
        rec = HeldBy(axes=axes, owner=owner, index=index, layer=None,
                     shape=shape, dtype=x.dtype, bounds=bounds,
                     device_mesh=dm, device=local.device)
        if owner == rec.position:
            rec = replace(rec, layer=views[index])
        out.append(rec)
    return out


def held_rows(x: HeldBy, split: bool) -> torch.Tensor:
    """This rank's rows (dim 0) of layer ``x``'s local tensor, held by the
    owner: it sends every other rank of ``x``'s line that rank's rows in
    one point-to-point batch and keeps its own; the others receive theirs
    from it (exact: raw bytes, through pinned host memory when the ranks
    share a card).  ``split``: the batch is split over the line, each rank
    taking its part of the rows in line order (pod-major); else every rank
    takes all of them.  Every rank of the line must call it for the same
    layer at the same point."""
    group = axes_group(x.device_mesh, x.dims)
    transport = group_transport(group, x.device)
    line = dist.get_process_group_ranks(group)
    n, me = x.size, x.position
    rows = x.shape[0] // n if split else x.shape[0]

    def part(r: int) -> slice:
        return slice(r * rows, (r + 1) * rows) if split else slice(0, rows)

    if x.layer is not None:
        local = x.layer.to_local()
        ops = [dist.P2POp(dist.isend, _to_wire(local[part(r)], transport),
                          line[r], group) for r in range(n) if r != x.owner]
        for w in (dist.batch_isend_irecv(ops) if ops else ()):
            w.wait()
        return local[part(me)]
    shape = (rows, *(b.stop - b.start for b in x.bounds[1:]))
    like = torch.empty(shape, dtype=x.dtype, device=x.device)
    buf = _wire_empty(like, transport)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, buf,
                                                line[x.owner], group)]):
        w.wait()
    return _from_wire(buf, like, transport)


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
    sum is the whole gradient — JAX's transpose of a replicated input).
    One node for all the leaves, so every rank sums them in one order."""

    @staticmethod
    def forward(ctx, groups, transport, *xs):
        ctx.groups, ctx.transport = groups, transport
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            for group in ctx.groups:
                g = reduce_over_ranks(g, group, ctx.transport, backward=True)
            out.append(g)
        return (None, None, *out)


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
        out = all_gather_cat(out, 1, group, mesh.transport)
    return out
