"""Mixture-of-Experts FFN — the port of the JAX package's ``models/moe.py``.

Two dispatches, chosen as there (:func:`moe_apply`):

* **sort** (:func:`_grouped_dispatch`): token→expert assignments are stably
  sorted by expert, each gets its position inside its expert's segment from
  a batched ``searchsorted``, assignments past the capacity C go to the
  overflow slot ``E*C`` (sliced away), and the expert FFNs run as one
  batched einsum over the ``[G, E, C, d]`` buffer;
* **einsum** (:func:`_einsum_dispatch`): GShard one-hot dispatch and
  combine masks ``[G, Ng, E, C]``, accumulated in the compute dtype.

The combine of the sort path is a gather in token order: each token reads
its k expert rows through their slots, weights them by gate·keep and sums
them over k in a fixed order.  The JAX code scatter-adds in slot order
(``.at[].add``); on the card that is a float-atomic ``index_add_``, whose
sums differ from run to run in the last bit.  The arithmetic is the same.

The router is f32 (``moe_init``); ``wi``/``wo`` take the config dtype.  The
JAX module's sharding anchors (``_con_experts``, ``_con_groups``) are the
identity without a mesh and the port has no mesh yet, so they are left out,
and :func:`moe_groups` is 1.

:func:`moe_ref` is a plain version that tests and ``chip_smoke.py`` hold
the dispatches to: each kept assignment's expert FFN in f32, under a given
routing.  The main path never calls it.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import _dense_init

Params = Any

EINSUM_GROUP = 512     # tokens per routing group on the einsum path
AUX_KEYS = ("load_balance_loss", "router_z_loss", "dropped_frac")

# None, or ``fn(router, logits, idx) -> idx``: called on every routing
# decision with the router weight, the f32 logits [G, Ng, E] and the top-k
# expert indices [G, Ng, k]; what it returns replaces the choices, and the
# gates are read again from the probabilities.  Tools use it to record a
# run's choices by layer (the router of each layer is its own tensor) and
# to pin them into another run.
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
    logits = torch.einsum("gnd,de->gne", xg.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    if ROUTING_HOOK is not None:
        chosen = ROUTING_HOOK(p["router"], logits, idx)
        if chosen is not idx:
            idx = chosen
            gate = torch.gather(probs, -1, idx)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    return logits, probs, gate, idx


def _aux(logits, probs, idx, dropped) -> dict:
    E = probs.shape[-1]
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(idx[..., 0], E).to(torch.float32), dim=(0, 1))
    return {"load_balance_loss": E * torch.sum(me * ce),
            "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
            "dropped_frac": dropped}


def _expert_ffn(p: Params, eb: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: [G, E, C, d] → [G, E, C, d]."""
    gu = torch.einsum("gecd,edkf->geckf", eb, p["wi"])
    h = F.silu(gu[:, :, :, 0]) * gu[:, :, :, 1]
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def _record(routing, logits, gate, idx, keep, C) -> None:
    if routing is not None:
        routing.update({"C": C, "logits": logits, "idx": idx, "gate": gate,
                        "keep": keep})


def _grouped_dispatch(p: Params, xg: torch.Tensor, top_k: int, C: int,
                      routing: dict | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """Sort-based dispatch and gather combine, batched over groups.
    xg: [G, Ng, d]."""
    G, N, d = xg.shape
    E = p["router"].shape[1]
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
        keep_s = pos < C
        dest_s = torch.where(keep_s, se * C + pos,
                             torch.full((), E * C, device=dev))
        # the slots back in token order ([G, Nk], assignment t*k + j)
        dest = torch.empty_like(dest_s).scatter_(1, order, dest_s)
        keep = torch.empty_like(keep_s).scatter_(1, order, keep_s)
        xs = torch.gather(xg, 1, st[..., None].expand(G, Nk, d))
        buf = torch.zeros((G, E * C + 1, d), dtype=xg.dtype, device=dev)
        buf = buf.scatter(1, dest_s[..., None].expand(G, Nk, d), xs)
        eb = buf[:, :E * C].reshape(G, E, C, d)

    with record_function("moe:experts"):
        out = _expert_ffn(p, eb).reshape(G, E * C, d)

    with record_function("moe:combine"):
        rows = torch.cat([out, torch.zeros((G, 1, d), dtype=out.dtype,
                                           device=dev)], dim=1)
        rows = torch.gather(rows, 1, dest[..., None].expand(G, Nk, d))
        w = (gate.reshape(G, Nk) * keep).to(xg.dtype)
        contrib = (rows * w[..., None]).reshape(G, N, top_k, d)
        y = contrib[:, :, 0]
        for j in range(1, top_k):
            y = y + contrib[:, :, j]

    keep = keep.reshape(G, N, top_k)
    _record(routing, logits, gate, idx, keep, C)
    return y, _aux(logits, probs, idx,
                   1.0 - torch.mean(keep.to(torch.float32)))


def _einsum_dispatch(p: Params, xg: torch.Tensor, top_k: int, C: int,
                     routing: dict | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """GShard-style all-einsum dispatch and combine. xg: [G, Ng, d], many
    groups of ~512 tokens."""
    G, N, d = xg.shape
    E = p["router"].shape[1]
    dt = xg.dtype
    with record_function("moe:route"):
        logits, probs, gate, idx = _route(p, xg, top_k)

    with record_function("moe:dispatch"):
        counts = torch.zeros((G, E), dtype=torch.float32, device=xg.device)
        disp = comb = None
        kept, keeps = 0.0, []
        for j in range(top_k):
            oh_e = F.one_hot(idx[..., j], E).to(torch.float32)     # [G,N,E]
            pos = counts[:, None, :] + torch.cumsum(oh_e, dim=1) - oh_e
            pos_j = torch.sum(pos * oh_e, dim=-1)                  # [G,N]
            keep_j = pos_j < C
            # jax.nn.one_hot gives a zero row at pos_j >= C, where
            # F.one_hot raises: clamp the index, then keep_j zeroes it
            oh_c = (F.one_hot(pos_j.to(torch.long).clamp(max=C - 1), C)
                    .to(torch.float32) * keep_j[..., None])
            # the [G,N,E,C] masks accumulate in the compute dtype: their
            # entries are exact {0, 1} / gate values
            m = oh_e.to(dt)[..., None] * oh_c.to(dt)[:, :, None, :]
            disp = m if disp is None else disp + m
            gj = gate[..., j, None, None].to(dt)
            comb = gj * m if comb is None else comb + gj * m
            counts = counts + torch.sum(oh_e, dim=1)
            kept = kept + torch.mean(keep_j.to(torch.float32))
            keeps.append(keep_j)
        eb = torch.einsum("gnec,gnd->gecd", disp, xg)

    with record_function("moe:experts"):
        out = _expert_ffn(p, eb)

    with record_function("moe:combine"):
        y = torch.einsum("gecd,gnec->gnd", out, comb)

    _record(routing, logits, gate, idx, torch.stack(keeps, dim=-1), C)
    return y, _aux(logits, probs, idx, 1.0 - kept / top_k)


def moe_groups(n_tokens: int, n_experts: int) -> int:
    """Routing-group count of the sort path: one group per batch shard in
    the JAX package; without a mesh (the port has none yet) one group."""
    del n_tokens, n_experts
    return 1


def moe_apply(p: Params, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, n_groups: int | None = None,
              mode: str | None = None, routing: dict | None = None
              ) -> tuple[torch.Tensor, dict]:
    """x [B, T, d] → (y [B, T, d], aux).  mode: "einsum" (GShard masks),
    "sort", or None: einsum when the tokens make at least 16 groups of
    :data:`EINSUM_GROUP`, else sort.  C = max(1, int(Ng * top_k / E *
    capacity_factor)).  ``routing``, when given, receives the decision:
    ``mode``, ``G``, ``C``, the f32 ``logits``, ``idx`` and ``gate``
    [G, Ng, k] and the ``keep`` mask [G, Ng, k]."""
    B, T, d = x.shape
    E = p["router"].shape[1]
    N = B * T
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
    if routing is not None:
        routing.update(mode=mode, G=G)
    y, aux = dispatch(p, x.reshape(G, Ng, d), top_k, C, routing)
    return y.reshape(B, T, d), aux


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
