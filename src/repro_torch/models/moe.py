"""Mixture-of-Experts FFN — the port of the JAX package's ``models/moe.py``.

Two dispatches, chosen as there (:func:`moe_apply`):

* **sort** (:func:`_grouped_dispatch`): token→expert assignments are stably
  sorted by expert, each gets its position inside its expert's segment from
  a batched ``searchsorted``, assignments past the capacity C go to the
  overflow slot ``E*C`` (sliced away), and the expert FFNs run as one
  batched einsum over the ``[G, E, C, d]`` buffer;
* **einsum** (:func:`_einsum_dispatch`): GShard one-hot dispatch masks
  ``[G, Ng, E, C]``, accumulated in the compute dtype.

Both combine by a gather in token order (:func:`_combine`): each token
reads its k expert rows through their slots, weights them by gate·keep and
sums them over k in a fixed order, in f64, rounded once to the compute
type by the caller.  A bf16 row times an f32 gate is exact in f64, and so
is the sum of k of them, in any order, so the one-process combine and the
expert-parallel ranks' partial sums and their sum over the model axis (in
f64) give the same bits.  The JAX code rounds the gates (and, on the sort
path, each weighted row) to the compute type, sums in it, and
scatter-adds in slot order (``.at[].add``, each add rounded; on the card a
float-atomic ``index_add_``, whose sums differ from run to run in the last
bit); its einsum path's combine is a second [G, Ng, E, C] mask, holding
the gates, and an einsum over it, the same k products summed.  At
moonshot's random init the expert rows are large (``wi``/``wo`` drawn with
fan-in E) and the model carries a last-bit difference in a layer's output
into ~1% of its logits six layers on and a few percent of some gradients
two layers on (``chip_smoke.py``'s ``ep`` phase): there a bf16 gate steps
a whole row by 2^-8 of itself where a router input moves in its last bit,
and an association-dependent sum puts the ranks' rows off the one-process
run's.

The router is f32 (``moe_init``); ``wi``/``wo`` take the config dtype.
:func:`moe_groups` reads the layout registered with
:func:`~repro_torch.models.layers.set_attention_mesh`, as the JAX function
reads its mesh: one routing group a batch shard, whose capacity decides
which tokens drop.

Expert parallelism across ranks (a ``(1, model)`` mesh; what GSPMD makes of
the JAX anchors): with ``wi``/``wo`` DTensors by ``param_shardings`` (E over
the model axis) each rank computes its own experts ``lo..hi-1`` only, on
its local weights, with the explicit collectives of
:mod:`repro_torch.core.spmd_pipeline`.  The routing stays whole on every
rank: the router is replicated, and its logits, the top-k, the capacity and
the keep set are computed over all E experts and all of a group's tokens,
so the drop set is the one-process one.  The ranks take the same choices
because they route the same bits: the activations between layers are whole
on every rank, each row split's f32 sum handed to every rank alike by the
gloo all-reduce (its ring sends each reduced segment from one rank to the
others), and the sequence-parallel carry gathered exactly (the tests and
``chip_smoke.py`` hold the ranks' own choices equal, bit for bit).  The sort
path builds the ``[G, E*C+1, d]`` buffer as before and runs the rank's
experts on its slice; the einsum path keeps the ``[G, Ng, E]`` counts,
positions and keep flags whole and builds only the rank's
``[G, Ng, E/m, C]`` dispatch mask.  Each rank's combine is a partial sum
over the assignments its experts took (the others count as zero rows),
summed over the model axis in f64 (exact, above) and rounded once to the
compute type, as a row split is.  Where the guard leaves E whole (E not
divided by the axis), every rank computes every expert and nothing is
summed.

Under autograd the router and the norm before it are used twice: whole by
the routing (the aux losses' gradient, whole on every rank) and split by
the experts (each rank's gates and tokens reach only its experts' rows).
The two sums over the model axis sit where the partial gradients arise: on
the normalised gates as they enter the combine and on the tokens as they
enter the dispatch (:func:`~repro_torch.core.spmd_pipeline.copy_to_ranks`),
so the router, the norm and everything upstream see whole gradients.

A batch split over a data axis (each rank its rows, ``data`` in
:func:`moe_apply`): the mode, the group count G and the capacity C are
decided from the global token count, as the JAX function decides them on
the global batch; each rank runs its G/n groups, or, where a group spans
several ranks' rows (G = 1 in decode), its part of the group, the
positions in each expert's segment counted on from the assignments of the
ranks before it (:func:`_peer_counts`; only counts move).  The aux losses
take the means over every group and token: ``me``, ``ce``, the router z
term and ``dropped_frac`` are averaged over the data axis (equal shards)
before the load-balance product, the sum's gradient passing as it is.
With a ``pod`` axis beside ``data`` the batch's line is the ``(pod,
data)`` group, its ranks pod-major, as the rows and ``moe_groups``'s
pod x data shards run.

:func:`moe_ref` is a plain version that tests and ``chip_smoke.py`` hold
the dispatches to: each kept assignment's expert FFN in f32, under a given
routing.  The main path never calls it.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.spmd_pipeline import (all_gather_cat, all_reduce_sum,
                                   copy_to_ranks, gather_over_ranks,
                                   local_bounds, own_part, reduce_scatter)
from .layers import _cut, _dense_init, _local, _model_line, attention_mesh

Params = Any

EINSUM_GROUP = 512     # tokens per routing group on the einsum path
AUX_KEYS = ("load_balance_loss", "router_z_loss", "dropped_frac")

# None, or ``fn(router, logits, idx) -> idx``: called on every routing
# decision with the router weight (the rank's local tensor, whole, under
# expert parallelism), the f32 logits [G, Ng, E] and the top-k expert
# indices [G, Ng, k]; what it returns replaces the choices, and the gates
# are read again from the probabilities.  Tools use it to record a run's
# choices by layer (the router of each layer is its own tensor, a view of
# the stacked one) and to pin them into another run.
ROUTING_HOOK = None


def moe_init(generator: torch.Generator, d: int, ff: int, n_experts: int,
             dtype: torch.dtype) -> Params:
    """The router in f32, ``wi`` [E, d, 2, ff] and ``wo`` [E, ff, d] in
    ``dtype``.  Their fan-in is ``shape[0]`` (= E), as ``_dense_init`` in
    the JAX package computes it."""
    return {
        "router": _dense_init(generator, (d, n_experts), torch.float32),
        "wi": _dense_init(generator, (n_experts, d, 2, ff), dtype),
        "wo": _dense_init(generator, (n_experts, ff, d), dtype),
    }


def _route(p: Params, xg: torch.Tensor, top_k: int):
    """f32 router logits [G, Ng, E], their softmax, the normalised top-k
    gates and expert indices [G, Ng, k]."""
    router = _local(p["router"])
    logits = torch.einsum("gnd,de->gne", xg.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    if ROUTING_HOOK is not None:
        chosen = ROUTING_HOOK(router, logits, idx)
        if chosen is not idx:
            idx = chosen
            gate = torch.gather(probs, -1, idx)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    return logits, probs, gate, idx


def _aux(logits, probs, idx, dropped, data=None) -> dict:
    """The aux losses of this rank's groups; over a batch split by the
    data axis (``data``) the means ``me`` and ``ce``, the router z term
    and ``dropped_frac`` are averaged over it first (in f32, one sum), so
    the load-balance product is of the global means."""
    E = probs.shape[-1]
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(idx[..., 0], E).to(torch.float32), dim=(0, 1))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if data is not None:
        n = dist.get_world_size(data[0])
        s = all_reduce_sum(torch.cat([me, ce, z[None], torch.as_tensor(
            dropped, dtype=torch.float32, device=me.device).reshape(1)]),
            *data) / n
        me, ce, z, dropped = s[:E], s[E:2 * E], s[2 * E], s[2 * E + 1]
    return {"load_balance_loss": E * torch.sum(me * ce),
            "router_z_loss": z, "dropped_frac": dropped}


def _peer_counts(counts: torch.Tensor, data: tuple, G: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Where a routing group spans several ranks' rows of a batch split
    over the batch's line ``data`` (G of them over its n ranks, n/G ranks
    a group, in group-rank order: pod-major over ``(pod, data)``): (the sum of ``counts`` over the ranks before this one in
    its group, their sum over the whole group).  ``counts`` are this
    rank's assignments by expert (exact integers); they are gathered over
    the axis, nothing else."""
    group, transport = data
    n, r = dist.get_world_size(group), dist.get_rank(group)
    span = n // G
    lo = r // span * span
    every = gather_over_ranks(counts[None].contiguous(), 0, group, transport)
    return every[lo:r].sum(0), every[lo:lo + span].sum(0)


def _expert_ffn(p: Params, eb: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: [G, E, C, d] → [G, E, C, d]
    (this rank's experts' local weights and buffers)."""
    gu = torch.einsum("gecd,edkf->geckf", eb, _local(p["wi"]))
    h = F.silu(gu[:, :, :, 0]) * gu[:, :, :, 1]
    return torch.einsum("gecf,efd->gecd", h, _local(p["wo"]))


def _dispatched(xg: torch.Tensor, line: tuple) -> torch.Tensor:
    """The tokens [G, Ng, d] as they enter this rank's experts: under
    autograd in f32, their gradient, a part on each rank (its experts'),
    summed over the model axis in f32 and rounded once to xg's type; else
    ``xg`` itself.  The dispatch moves the values unchanged (a gather, or
    a one-hot product)."""
    if not (torch.is_grad_enabled() and xg.requires_grad):
        return xg
    return copy_to_ranks(xg.to(torch.float32), *line)


def _combine(out: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor,
             keep: torch.Tensor, lo: int, C: int,
             line: tuple | None) -> torch.Tensor:
    """y [G, Ng, d] in f64: each token's k rows of ``out`` [G, n·C, d]
    (the slots of experts ``lo..lo+n-1``) read through their slots
    ``dest`` [G, Ng, k] (in the whole ``[G, E·C]`` buffer; a slot outside
    this rank's, or a dropped assignment's ``E·C``, reads a zero row),
    weighted by gate·keep and summed over k in order, in f64.  Under
    expert parallelism (``line``) the gates' gradient, a part on each rank,
    is summed over the model axis."""
    G, N, k = dest.shape
    d, n = out.shape[-1], out.shape[1]
    rows = torch.cat([out, out.new_zeros((G, 1, d))], dim=1)
    at = dest - lo * C
    at = torch.where((at >= 0) & (at < n), at,
                     torch.full((), n, device=at.device))
    rows = torch.gather(rows, 1, at.reshape(G, N * k, 1).expand(G, N * k, d)
                        ).reshape(G, N, k, d)
    g = gate if line is None else copy_to_ranks(gate, *line)
    w = (g * keep).to(torch.float64)[..., None]
    # one f64 pass over y a row: the bf16 rows promote as they are read
    y = rows[:, :, 0] * w[:, :, 0]
    for j in range(1, k):
        y = torch.addcmul(y, rows[:, :, j], w[:, :, j])
    return y


def _experts(p: Params) -> tuple[int, int, tuple | None]:
    """(lo, hi, line): this rank's experts ``lo..hi-1`` (its rows of ``wi``
    and ``wo``), and the model axis's (process group, transport) when the
    ranks split E; ``(0, E, None)`` for plain weights and where the guard
    left E whole."""
    wi, wo = p["wi"], p["wo"]
    rows = local_bounds(wi)[0]
    if local_bounds(wo)[0] != rows:
        raise ValueError(f"moe/wo rows {local_bounds(wo)[0]} are not this "
                         f"rank's experts {rows}")
    if rows.stop - rows.start == wi.shape[0]:
        return 0, wi.shape[0], None
    return rows.start, rows.stop, _model_line(wi)


def _record(routing, logits, gate, idx, keep, C) -> None:
    if routing is not None:
        routing.update({"C": C, "logits": logits, "idx": idx, "gate": gate,
                        "keep": keep})


def _grouped_dispatch(p: Params, xg: torch.Tensor, top_k: int, C: int,
                      routing: dict | None = None, data=None,
                      peers=None) -> tuple[torch.Tensor, dict]:
    """Sort-based dispatch and gather combine, batched over groups.
    xg: [G, Ng, d] → y [G, Ng, d] in f64 (each token's k rows weighted and
    summed in f64, for the caller to round once); under expert parallelism
    this rank's partial sum (the module docstring).  ``data``: the batch's
    data axis (the aux means over it); ``peers``: the group count when
    this rank's tokens are a part of one group spanning ranks
    (:func:`_peer_counts`)."""
    G, N, d = xg.shape
    E = p["router"].shape[1]
    lo, hi, line = _experts(p)
    Nk = N * top_k
    dev = xg.device
    with record_function("moe:route"):
        logits, probs, gate, idx = _route(p, xg, top_k)

    with record_function("moe:dispatch"):
        flat_e = idx.reshape(G, Nk)
        flat_t = torch.arange(N, device=dev).repeat_interleave(top_k)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        se = torch.gather(flat_e, 1, order)
        st = flat_t[order]                                      # [G, Nk]
        seg_start = torch.searchsorted(
            se, torch.arange(E, device=dev).expand(G, E).contiguous())
        pos = (torch.arange(Nk, device=dev)[None]
               - torch.gather(seg_start, 1, se))
        if peers is not None:           # the group's earlier ranks' first
            ends = torch.cat([seg_start[:, 1:], torch.full(
                (G, 1), Nk, device=dev, dtype=seg_start.dtype)], 1)
            before, _ = _peer_counts(ends - seg_start, data, peers)
            pos = pos + torch.gather(before, 1, se)
        keep_s = pos < C
        dest_s = torch.where(keep_s, se * C + pos,
                             torch.full((), E * C, device=dev))
        # the slots back in token order ([G, Nk], assignment t*k + j)
        dest = torch.empty_like(dest_s).scatter_(1, order, dest_s)
        keep = torch.empty_like(keep_s).scatter_(1, order, keep_s)
        xd = xg if line is None else _dispatched(xg, line)
        xs = torch.gather(xd, 1, st[..., None].expand(G, Nk, d))
        buf = torch.zeros((G, E * C + 1, d), dtype=xd.dtype, device=dev)
        buf = buf.scatter(1, dest_s[..., None].expand(G, Nk, d), xs)
        eb = _cut(buf[:, :E * C].reshape(G, E, C, d), 1, lo, hi).to(xg.dtype)

    with record_function("moe:experts"):
        out = _expert_ffn(p, eb).reshape(G, (hi - lo) * C, d)

    keep = keep.reshape(G, N, top_k)
    with record_function("moe:combine"):
        y = _combine(out, dest.reshape(G, N, top_k), gate, keep, lo, C, line)

    _record(routing, logits, gate, idx, keep, C)
    return y, _aux(logits, probs, idx,
                   1.0 - torch.mean(keep.to(torch.float32)), data)


def _einsum_dispatch(p: Params, xg: torch.Tensor, top_k: int, C: int,
                     routing: dict | None = None, data=None,
                     peers=None) -> tuple[torch.Tensor, dict]:
    """GShard-style einsum dispatch and the gather combine, batched over
    groups. xg: [G, Ng, d], many groups of ~512 tokens → y [G, Ng, d] in
    f64 (:func:`_combine`, for the caller to round once).  Under expert
    parallelism the dispatch mask is this rank's experts' and the result
    its partial sum.  ``data`` and ``peers`` as in
    :func:`_grouped_dispatch`: slot j's positions start after every
    assignment of the slots before it in the group and of the group's
    earlier ranks in slot j."""
    G, N, d = xg.shape
    E = p["router"].shape[1]
    lo, hi, line = _experts(p)
    dt = xg.dtype
    with record_function("moe:route"):
        logits, probs, gate, idx = _route(p, xg, top_k)

    with record_function("moe:dispatch"):
        xd = xg if line is None else _dispatched(xg, line)
        # each slot's assignments by expert [G, k, E] (exact integers)
        slots = torch.zeros((G, top_k, E), dtype=torch.float32,
                            device=xg.device).scatter_add_(
            2, idx.transpose(1, 2), torch.ones(idx.transpose(1, 2).shape,
                                               device=xg.device))
        before, total = ((0.0, slots) if peers is None
                         else _peer_counts(slots, data, peers))
        base = torch.cumsum(total, dim=1) - total + before
        disp = None
        kept, keeps, dests = 0.0, [], []
        for j in range(top_k):
            oh_e = F.one_hot(idx[..., j], E).to(torch.float32)     # [G,N,E]
            pos = base[:, j, None, :] + torch.cumsum(oh_e, dim=1) - oh_e
            pos_j = torch.sum(pos * oh_e, dim=-1)                  # [G,N]
            keep_j = pos_j < C
            # jax.nn.one_hot gives a zero row at pos_j >= C, where
            # F.one_hot raises: clamp the index, then keep_j zeroes it
            oh_c = (F.one_hot(pos_j.to(torch.long).clamp(max=C - 1), C)
                    .to(dt) * keep_j[..., None].to(dt))
            # the [G,N,E,C] mask (this rank's experts') accumulates in the
            # compute dtype: its entries are exact {0, 1}
            m = _cut(oh_e, 2, lo, hi).to(dt)[..., None] * oh_c[:, :, None, :]
            disp = m if disp is None else disp + m
            kept = kept + torch.mean(keep_j.to(torch.float32))
            keeps.append(keep_j)
            dests.append(torch.where(keep_j, idx[..., j] * C
                                     + pos_j.to(torch.long),
                                     torch.full((), E * C,
                                                device=xg.device)))
        eb = torch.einsum("gnec,gnd->gecd", disp.to(xd.dtype), xd).to(dt)

    with record_function("moe:experts"):
        out = _expert_ffn(p, eb).reshape(G, (hi - lo) * C, d)

    keep = torch.stack(keeps, dim=-1)
    with record_function("moe:combine"):
        y = _combine(out, torch.stack(dests, dim=-1), gate, keep, lo, C,
                     line)

    _record(routing, logits, gate, idx, keep, C)
    return y, _aux(logits, probs, idx, 1.0 - kept / top_k, data)


def moe_groups(n_tokens: int, n_experts: int) -> int:
    """Routing-group count of the sort path: one group per batch shard
    (pod x data of the registered layout), or 1 without a layout, or when
    the tokens do not divide or leave a shard fewer than 4 per expert."""
    mesh = attention_mesh()
    if mesh is None:
        return 1
    shards = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            shards *= mesh.shape[a]
    if n_tokens % shards or (n_tokens // shards) < 4 * n_experts:
        return 1
    return shards


def moe_apply(p: Params, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, n_groups: int | None = None,
              mode: str | None = None, routing: dict | None = None, *,
              seq: bool = False, data: tuple | None = None
              ) -> tuple[torch.Tensor, dict]:
    """x [B, T, d] → (y [B, T, d], aux).  mode: "einsum" (GShard masks),
    "sort", or None: einsum when the tokens make at least 16 groups of
    :data:`EINSUM_GROUP`, else sort.  C = max(1, int(Ng * top_k / E *
    capacity_factor)).  ``routing``, when given, receives the decision:
    ``mode``, ``G``, ``C``, the f32 ``logits``, ``idx`` and ``gate``
    [G, Ng, k] and the ``keep`` mask [G, Ng, k] (this rank's groups).

    Under expert parallelism (DTensor weights, the module docstring) each
    rank's partial sum is summed over the model axis in f64 and rounded
    once to x's type.  ``seq``: x is this rank's part of the tokens along
    T (the sequence-parallel carry); the parts are gathered before the
    routing, which sees every token, and the result is this rank's part
    (the sum's part, or the whole result's).  The gather's gradient is the
    rank's slice of a gradient already whole on every rank, not summed.
    ``data``: x is this rank's rows of a batch split over the data axis,
    whose (process group, transport) this is; mode, ``n_groups`` (G) and C
    are the global batch's, and the aux losses its means (the module
    docstring)."""
    line = _experts(p)[2]
    if seq:
        seq_line = _model_line(p["wi"])
        x = all_gather_cat(x, 1, *seq_line)
    B, T, d = x.shape
    E = p["router"].shape[1]
    n = 1 if data is None else dist.get_world_size(data[0])
    N = B * T * n                       # the global batch's tokens
    if mode is None:
        mode = ("einsum" if N % EINSUM_GROUP == 0
                and N // EINSUM_GROUP >= 16 else "sort")
    if mode == "einsum":
        G = N // EINSUM_GROUP if n_groups is None else n_groups
        dispatch = _einsum_dispatch
    else:
        G = n_groups if n_groups is not None else moe_groups(N, E)
        dispatch = _grouped_dispatch
    Ng = N // G
    C = max(1, int(Ng * top_k / E * capacity_factor))
    if G % n == 0:                      # this rank's G/n whole groups
        Gl, peers = G // n, None
    elif n % G == 0:                    # its part of a group of n/G ranks
        Gl, peers = 1, G
    else:
        raise NotImplementedError(f"{G} routing groups over a batch split "
                                  f"{n} ways")
    if routing is not None:
        routing.update(mode=mode, G=G)
    y, aux = dispatch(p, x.reshape(Gl, B * T // Gl, d), top_k, C, routing,
                      data, peers)
    y = y.reshape(B, T, d)
    if line is not None:                 # the ranks' partial sums, in f64
        y = (reduce_scatter(y, 1, *line) if seq
             else all_reduce_sum(y, *line))
    elif seq:
        y = own_part(y, 1, *seq_line)
    return y.to(x.dtype), aux


def moe_ref(p: Params, x: torch.Tensor, idx: torch.Tensor,
            gate: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The plain MoE under a given routing: x [N, d], idx/gate/keep [N, k]
    → y [N, d] f32, the sum over each token's kept assignments of gate x
    its expert's SwiGLU, all in f32.  Each assignment's row is written to
    its own place and the k rows are summed in order, so no two runs
    differ."""
    N, d = x.shape
    k = idx.shape[1]
    xf = x.to(torch.float32)
    out = torch.zeros((N, k, d), dtype=torch.float32, device=x.device)
    for e in torch.unique(idx[keep]).tolist():
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        gu = torch.einsum("nd,dcf->ncf", xf[t], p["wi"][e].to(torch.float32))
        h = F.silu(gu[:, 0]) * gu[:, 1]
        out[t, j] = (h @ p["wo"][e].to(torch.float32)
                     ) * gate[t, j, None].to(torch.float32)
    return out.sum(dim=1)
