"""Model-zoo library ops — the general trace→pipeline path.

The paper's headline promise is acceleration *without user intervention*:
trace an unmodified program, recover the causal call graph, and build the
mixed pipeline automatically.  :mod:`repro_torch.models.harris` does that
for the paper's own vision demo; this module generalizes it to a
transformer.  Every layer-level building block (attention, rmsnorm,
matmul/FFN, MoE dispatch, RWKV token-shift, SSM scan) becomes a
ModuleDatabase row behind the interposable :class:`~repro_torch.core.
tracer.Library`, so a transformer forward pass written against ``lib.*`` —
with its weights held in an ordinary Python closure, exactly like a loaded
checkpoint — traces into a :class:`~repro_torch.core.ir.CourierIR` that the
Pipeline Generator can partition, fuse (the rmsnorm+matmul kernel, K6),
replicate, verify, and serve.

The tracer observes rank-2 ``[T, d]`` activations (one sequence per
pipeline token), which keeps the rmsnorm module's shape gate
(``len(shape) == 2``) satisfied so fusion fires on the traced graph.  Every
software row also takes leading batch dims, ``[..., T, d]``: that is how the
executor's micro-batching replaces the JAX package's ``jax.vmap`` — a
stacked group of B sequences goes through each row in one call.

The functions keep the JAX package's layouts and order of operations
(``src/repro/models/zoo.py``), so the parity tests compare like with like.

Incremental decode (:func:`make_decode_attention`, registered by
:func:`register_decode_modules`) is the one stateful row: one new token
per call, its keys and values appended to a
:class:`~repro_torch.runtime.kvstate.KVSlotPool` slot on the pool's device.
Like the JAX package's, it is plain tensor code, not a kernel.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..core.costmodel import NodeCost, elementwise_cost, matmul_cost
from ..core.database import ModuleDatabase
from ..core.placement import resolve_device
from ..kernels.ops import register_rmsnorm_matmul_modules

__all__ = ["make_zoo_db", "transformer_demo", "init_transformer_params",
           "params_from_numpy", "recurrent_demo", "init_recurrent_params",
           "make_decode_attention", "register_decode_modules"]


# --------------------------------------------------------------------------- #
# Software implementations (the "original binary" the Frontend interposes on)
# --------------------------------------------------------------------------- #
def sw_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                 wv: torch.Tensor, wo: torch.Tensor, *, n_heads: int,
                 theta: float = 10000.0) -> torch.Tensor:
    """Causal self-attention with RoPE. x: [..., T, d]."""
    *lead, T, d = x.shape
    hd = d // n_heads
    q = (x @ wq).reshape(*lead, T, n_heads, hd)
    k = (x @ wk).reshape(*lead, T, n_heads, hd)
    v = (x @ wv).reshape(*lead, T, n_heads, hd)
    q, k = _rope(q, theta), _rope(k, theta)
    s = torch.einsum("...thi,...mhi->...htm", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    t = torch.arange(T, device=x.device)
    s = s.masked_fill(t[:, None] < t[None, :], -1e30)          # causal
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("...htm,...mhi->...thi", p, v.to(torch.float32))
    return y.reshape(*lead, T, d).to(x.dtype) @ wo


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: [..., T, H, hd]."""
    T, _, hd = x.shape[-3:]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = (torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
           * freq)                                               # [T, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _rope_at(x: torch.Tensor, pos: int, theta: float) -> torch.Tensor:
    """Rotary embedding of ONE token at absolute position ``pos``;
    x: [1, H, hd].  The same f32 angle math as row ``pos`` of :func:`_rope`
    over the full prefix, which is what makes incremental decode agree
    with re-running the prefix."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.tensor(float(pos), dtype=torch.float32,
                       device=x.device) * freq                   # [half]
    cos, sin = torch.cos(ang)[None, None, :], torch.sin(ang)[None, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def make_decode_attention(pool: Any, *, n_heads: int,
                          theta: float = 10000.0,
                          k_buf: str = "k", v_buf: str = "v") -> Callable:
    """Incremental decode attention over a KV slot pool (STATEFUL).

    Returns ``attn(x, slot, wq, wk, wv, wo) -> [1, d]``: one new token
    ``x: [1, d]`` plus its request's ``slot`` id (an int or a 0-d tensor;
    ``-1`` = dead row).  The op reads the slot's cached (rotated)
    keys/values, projects and RoPE-rotates the new token at absolute
    position ``len(slot)``, appends its k/v row to the cache, and attends
    over cache + self — an O(prefix) step instead of the O(prefix²)
    full-prefix re-run of :func:`sw_attention`, which it equals up to the
    rounding of the two orders of work.

    The cache lives on the pool's device, so on the card a step reads and
    appends the slot there.  Register it with ``state=`` (see
    :func:`register_decode_modules`) so the tracer marks the node
    ``serial_only``; its row takes no batch dims, so a micro-batched group
    runs it once per row, in row order.  A dead row (``slot < 0``) appends
    nothing and attends over only itself, so padding and evicted seats in
    a continuously batched group leave the pool untouched.
    """
    def attention_decode(x: torch.Tensor, slot: Any, wq: torch.Tensor,
                         wk: torch.Tensor, wv: torch.Tensor,
                         wo: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        hd = d // n_heads
        s_id = int(slot)
        pos = pool.length(s_id)
        q = (x @ wq).reshape(1, n_heads, hd)
        k = (x @ wk).reshape(1, n_heads, hd)
        v = (x @ wv).reshape(1, n_heads, hd)
        q, k = _rope_at(q, pos, theta), _rope_at(k, pos, theta)
        cache = pool.read(s_id)
        pool.append(s_id, **{k_buf: k[0], v_buf: v[0]})
        K = torch.cat([cache[k_buf].to(device=x.device, dtype=x.dtype), k])
        V = torch.cat([cache[v_buf].to(device=x.device, dtype=x.dtype), v])
        s = torch.einsum("thi,mhi->htm", q.to(torch.float32),
                         K.to(torch.float32)) / math.sqrt(hd)
        # causality is structural: the cache holds only positions < pos
        p = torch.softmax(s, dim=-1)
        y = torch.einsum("htm,mhi->thi", p, V.to(torch.float32))
        return y.reshape(1, d).to(x.dtype) @ wo

    attention_decode.__name__ = "attention_decode"
    return attention_decode


def register_decode_modules(db: ModuleDatabase, pool: Any, *,
                            n_heads: int, theta: float = 10000.0,
                            name: str = "attention_decode",
                            state: str = "kv") -> None:
    """Register the stateful incremental-decode attention row.

    ``state=`` marks the row stateful: the tracer threads it onto the
    traced ``Node.state`` (implying ``serial_only``), and fusion,
    replication and hw placement all refuse it (the ``state-slot`` verify
    rule enforces the same).  Multi-layer models register one row per
    layer, each with its own pool.
    """
    db.register(name, software=make_decode_attention(
        pool, n_heads=n_heads, theta=theta),
        cost_sw=_c_attn, tags=("zoo", "decode"), state=state)


def sw_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Residual add."""
    return a + b


def sw_swiglu(x: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN. x: [..., T, d], wi: [d, 2*ff], wo: [ff, d]."""
    h = x @ wi
    g, u = torch.chunk(h, 2, dim=-1)
    return (F.silu(g) * u) @ wo


def sw_moe(x: torch.Tensor, gate_w: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor, *, top_k: int = 2) -> torch.Tensor:
    """Top-k MoE dispatch (dense einsum form). x: [..., T, d], gate_w:
    [d, E], w_in: [E, d, ff], w_out: [E, ff, d]."""
    logits = (x @ gate_w).to(torch.float32)                      # [..., T, E]
    E = logits.shape[-1]
    kth = torch.sort(logits, dim=-1).values[..., E - top_k][..., None]
    probs = torch.softmax(logits.masked_fill(logits < kth, -math.inf),
                          dim=-1)                                # [..., T, E]
    h = F.silu(torch.einsum("...td,edf->...tef", x, w_in))
    y = torch.einsum("...tef,efd->...ted", h, w_out)
    return torch.einsum("...te,...ted->...td", probs, y).to(x.dtype)


def sw_rwkv_shift(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """RWKV token-shift mix: blend each token with its predecessor.
    x: [..., T, d], mu: [d]."""
    prev = torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]],
                     dim=-2)
    return x + (prev - x) * mu


def sw_ssm_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """Diagonal linear state-space scan: h_t = a*h + b*x_t; y_t = c*h_t.
    x: [..., T, d]; a, b, c: [d] with a in (0, 1).  The reference's
    ``lax.scan`` over T is a loop here."""
    h = torch.zeros_like(x[..., 0, :])
    ys = []
    for t in range(x.shape[-2]):
        h = a * h + b * x[..., t, :]
        ys.append(c * h)
    return torch.stack(ys, dim=-2).to(x.dtype)


# --------------------------------------------------------------------------- #
# Cost providers (the synthesis-report analog for the sw rows)
# --------------------------------------------------------------------------- #
def _c_attn(shapes, dtypes, params) -> NodeCost:
    (T, d) = shapes[0]
    proj = matmul_cost(T, d, d, bytes_per_el=4, batch=4)   # q/k/v/o projections
    mix = matmul_cost(T, T, d, bytes_per_el=4, batch=2)    # QK^T and PV
    return NodeCost(flops=proj.flops + mix.flops,
                    bytes_rw=proj.bytes_rw + mix.bytes_rw,
                    f32_flops=proj.f32_flops + mix.f32_flops)


def _c_add(shapes, dtypes, params) -> NodeCost:
    return elementwise_cost(int(np.prod(shapes[0])), bytes_per_el=4)


def _c_swiglu(shapes, dtypes, params) -> NodeCost:
    (T, d), (_, two_ff) = shapes[0], shapes[1]
    ff = two_ff // 2
    up = matmul_cost(T, two_ff, d, bytes_per_el=4)
    down = matmul_cost(T, d, ff, bytes_per_el=4)
    return NodeCost(flops=up.flops + down.flops,
                    bytes_rw=up.bytes_rw + down.bytes_rw,
                    f32_flops=up.f32_flops + down.f32_flops)


def _c_moe(shapes, dtypes, params) -> NodeCost:
    (T, d), (_, E) = shapes[0], shapes[1]
    ff = shapes[2][2]
    return matmul_cost(T, ff, d, bytes_per_el=4, batch=2 * E)


def _c_scan(shapes, dtypes, params) -> NodeCost:
    return elementwise_cost(int(np.prod(shapes[0])), flops_per_el=4,
                            bytes_per_el=4, n_operands=4)


# --------------------------------------------------------------------------- #
# The zoo database
# --------------------------------------------------------------------------- #
def make_zoo_db() -> ModuleDatabase:
    """ModuleDatabase with every model-zoo layer op registered.

    rmsnorm (K5), matmul and the fused rmsnorm+matmul module (K6) come from
    :func:`repro_torch.kernels.ops.register_rmsnorm_matmul_modules`.  The
    remaining ops are software rows (database miss → sw placement), which
    keeps the traced graph *mixed*: hw islands separated by sw nodes.
    """
    db = ModuleDatabase("zoo")
    register_rmsnorm_matmul_modules(db)
    for name, fn, cost in (("attention", sw_attention, _c_attn),
                           ("add", sw_add, _c_add),
                           ("swiglu", sw_swiglu, _c_swiglu),
                           ("moe", sw_moe, _c_moe),
                           ("rwkv_shift", sw_rwkv_shift, _c_scan),
                           ("ssm_scan", sw_ssm_scan, _c_scan)):
        db.register(name, software=fn, cost_sw=cost, tags=("zoo",),
                    batch_dims=True)
    return db


# --------------------------------------------------------------------------- #
# Demo apps (unmodified user code over the interposable Library)
# --------------------------------------------------------------------------- #
def init_transformer_params(generator: torch.Generator, *, n_layers: int = 2,
                            d: int = 128, ff: int = 256, n_heads: int = 4,
                            vocab: int = 512, device=None) -> dict:
    """Random checkpoint for :func:`transformer_demo` (float32), drawn from
    ``generator`` directly on ``device`` (the card unless the caller asks
    for the CPU): at DeepSeek-67B widths the weights are ~10 GB and should
    not pass through the host.  ``generator`` must live on that device."""
    dev = resolve_device(device)

    def dense(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) * shape[0] ** -0.5

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    layers = []
    for _ in range(n_layers):
        layers.append({
            "ln1": zeros(d),
            "wq": dense((d, d)), "wk": dense((d, d)),
            "wv": dense((d, d)), "wo": dense((d, d)),
            "ln2": zeros(d),
            "wi": dense((d, 2 * ff)),
            "wo_ffn": dense((ff, d)),
        })
    return {"layers": layers, "n_heads": n_heads, "theta": 10000.0,
            "ln_f": zeros(d), "w_out": dense((d, vocab))}


def params_from_numpy(tree: Any, device=None) -> Any:
    """The JAX package's parameter tree, as numpy arrays (or any array
    exposing ``__array__``), turned into the port's: every array leaf
    becomes a float32 tensor on ``device``, other leaves pass through.  Both
    packages then compute the same function in the tests."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    if hasattr(tree, "__array__"):
        return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dev)
    return tree


def transformer_demo(lib: Any, params: dict) -> Callable:
    """Pre-norm transformer forward over ``lib.*`` calls; weights closed over.

    The returned ``app(x)`` is the "unmodified binary": it never mentions
    tracing, placement, or pipelines.  Every weight reaches the Frontend as
    a mid-trace first sighting (a captured graph input), and the final
    ``rmsnorm → matmul`` (lm head) pair is the branch-free hw run the
    fusion pass collapses into K6.
    """
    n_heads = int(params["n_heads"])
    theta = float(params["theta"])

    def app(x: torch.Tensor) -> torch.Tensor:    # x: [T, d] embeddings
        for ly in params["layers"]:
            h = lib.rmsnorm(x, ly["ln1"])
            a = lib.attention(h, ly["wq"], ly["wk"], ly["wv"], ly["wo"],
                              n_heads=n_heads, theta=theta)
            x = lib.add(x, a)
            h = lib.rmsnorm(x, ly["ln2"])
            f = lib.swiglu(h, ly["wi"], ly["wo_ffn"])
            x = lib.add(x, f)
        h = lib.rmsnorm(x, params["ln_f"])
        return lib.matmul(h, params["w_out"])    # logits [T, vocab]

    app.__name__ = "transformer"
    return app


def init_recurrent_params(generator: torch.Generator, *, d: int = 64,
                          device=None) -> dict:
    """Random weights for :func:`recurrent_demo` (RWKV shift + SSM scan)."""
    dev = resolve_device(device)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((d,), generator=generator,
                                           dtype=torch.float32, device=dev)

    return {"mu": uniform(0.1, 0.9), "a": uniform(0.5, 0.95),
            "b": torch.ones((d,), device=dev),
            "c": torch.ones((d,), device=dev),
            "ln": torch.zeros((d,), device=dev)}


def recurrent_demo(lib: Any, params: dict) -> Callable:
    """Minimal RWKV/SSM-style block: shift-mix → norm → scan → residual."""
    def app(x: torch.Tensor) -> torch.Tensor:    # x: [T, d]
        h = lib.rwkv_shift(x, params["mu"])
        h = lib.rmsnorm(h, params["ln"])
        y = lib.ssm_scan(h, params["a"], params["b"], params["c"])
        return lib.add(x, y)

    app.__name__ = "recurrent"
    return app
