"""The port's MoE FFN on the CPU, held against the JAX package.

* ``moe_apply`` against the JAX ``moe_apply`` on the same numpy weights and
  inputs: sort and einsum dispatch, with and without capacity drops,
  ``n_groups`` 1 and 4, f32 and bf16 (2e-4 and 2e-2 of the largest
  |reference|); every aux value; the kept set against a numpy oracle of
  each dispatch's rule (sort: token order; einsum: GShard k-slot order)
  fed with the JAX top-k choices;
* the counterparts of ``tests/test_moe_ssm.py``'s five MoE tests (router
  invariants, capacity drops, a single expert is the dense FFN, grouping
  keeps the semantics, einsum = sort in outputs and gradients);
* the einsum path's one-hot at positions past the capacity (a zero row in
  JAX, an index error in ``F.one_hot`` unless clamped);
* ``moe_ref`` (the plain version under a given routing) against both
  dispatches, and the gather combine's run-to-run equality;
* ``params_from_numpy`` and ``LM.init`` keep the router in f32 in a bf16
  model.

The routing compares discrete choices made by two packages, so every case
first checks that no token's k-th and (k+1)-th probabilities lie within
1e-4 of each other: there the two packages' f32 sums may round apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.moe as JM
from repro.models import LM as JLM
from repro_torch import configs
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.transformer import params_from_numpy

torch.set_num_threads(1)

D, FF, E, K = 16, 32, 8, 2
TIE_GAP = 1e-4


def _weights(seed, d=D, ff=FF, e=E):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((d, e)) * d ** -0.5
                       ).astype(np.float32),
            "wi": (rng.standard_normal((e, d, 2, ff)) * d ** -0.5
                   ).astype(np.float32),
            "wo": (rng.standard_normal((e, ff, d)) * ff ** -0.5
                   ).astype(np.float32)}


def _to_jax(w, dtype):
    return {"router": jnp.asarray(w["router"]),
            "wi": jnp.asarray(w["wi"]).astype(dtype),
            "wo": jnp.asarray(w["wo"]).astype(dtype)}


def _to_torch(w, dtype):
    return {"router": torch.from_numpy(w["router"]),
            "wi": torch.from_numpy(w["wi"]).to(dtype),
            "wo": torch.from_numpy(w["wo"]).to(dtype)}


def _jax_topk(w, x, G, k):
    """The JAX package's routing of x [N, d] in G groups: (probs, idx)
    [G, Ng, *], computed as ``moe.py`` computes it."""
    xg = jnp.asarray(x, jnp.float32).reshape(G, -1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", xg,
                                      jnp.asarray(w["router"])), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    return np.asarray(probs), np.asarray(idx)


def _no_near_tie(probs, k):
    s = -np.sort(-probs, axis=-1)
    gap = s[..., k - 1] - s[..., k]
    assert gap.min() > TIE_GAP, f"a near-tie in the routing: {gap.min()}"


def _keep_oracle(idx, C, mode):
    """Which assignments [G, Ng, k] fit in capacity C: sort ranks them in
    token order (t, then j), einsum in k-slot order (j, then t)."""
    G, N, k = idx.shape
    keep = np.zeros(idx.shape, bool)
    for g in range(G):
        fill = np.zeros(idx.max() + 1, int)
        order = ([(t, j) for t in range(N) for j in range(k)]
                 if mode == "sort" else
                 [(t, j) for j in range(k) for t in range(N)])
        for t, j in order:
            e = idx[g, t, j]
            keep[g, t, j] = fill[e] < C
            fill[e] += 1
    return keep


def _close(got, want, tol):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


# --------------------------------------------------------------------------- #
# moe_apply against the JAX moe_apply
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_groups", [1, 4])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5],
                         ids=["no_drops", "drops"])
@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_moe_apply_matches_jax(mode, capacity_factor, n_groups, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    w = _weights(0)
    x = np.random.default_rng(1).standard_normal((2, 64, D),
                                                 dtype=np.float32)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    yj, aj = JM.moe_apply(_to_jax(w, jdt), xj, K, capacity_factor,
                          n_groups, mode)
    routing = {}
    yt, at = TM.moe_apply(_to_torch(w, tdt), xt, K, capacity_factor,
                          n_groups, mode, routing=routing)
    assert yt.dtype == tdt and routing["mode"] == mode
    assert routing["G"] == n_groups
    _close(yt, yj, tol)
    assert set(at) == set(aj) == set(TM.AUX_KEYS)
    for key in aj:
        np.testing.assert_allclose(float(at[key]), float(aj[key]),
                                   rtol=1e-5, atol=1e-6)
    probs, idx = _jax_topk(w, np.asarray(xj.astype(jnp.float32)).reshape(
        -1, D), n_groups, K)
    _no_near_tie(probs, K)
    np.testing.assert_array_equal(routing["idx"].numpy(), idx)
    keep = _keep_oracle(idx, routing["C"], mode)
    np.testing.assert_array_equal(routing["keep"].numpy(), keep)
    assert (capacity_factor < 1) == (not keep.all())
    np.testing.assert_allclose(float(at["dropped_frac"]),
                               1.0 - keep.mean(), atol=1e-6)


@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_moe_apply_picks_the_dispatch_and_capacity_as_jax(mode):
    """Auto mode: einsum once the tokens make 16 groups of 512, else sort;
    C = max(1, int(Ng * k / E * capacity_factor))."""
    w = _to_torch(_weights(2), torch.float32)
    T = 16 * TM.EINSUM_GROUP // 2 if mode == "einsum" else 8
    routing = {}
    TM.moe_apply(w, torch.zeros((2, T, D)), K, 1.25, routing=routing)
    G = 16 if mode == "einsum" else 1
    Ng = 2 * T // G
    assert (routing["mode"], routing["G"]) == (mode, G)
    assert routing["C"] == max(1, int(Ng * K / E * 1.25))
    # decode at batch 4 (moonshot: 64 experts, top 6): sort, G 1, C 1
    r = {}
    TM.moe_apply(_to_torch(_weights(3, e=64), torch.float32),
                 torch.zeros((4, 1, D)), 6, 1.25, routing=r)
    assert (r["mode"], r["G"], r["C"]) == ("sort", 1, 1)


# --------------------------------------------------------------------------- #
# the counterparts of tests/test_moe_ssm.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,T,E_", [(1, 2, 4), (2, 5, 8), (3, 8, 4),
                                    (3, 3, 8)])
def test_moe_router_invariants(B, T, E_):
    d, ff, k = 16, 32, 2
    w = _weights(B * 10 + T, d, ff, E_)
    x = np.random.default_rng(T).standard_normal((B, T, d), dtype=np.float32)
    y, aux = TM.moe_apply(_to_torch(w, torch.float32), torch.from_numpy(x),
                          top_k=k, capacity_factor=8.0)   # no drops
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux["dropped_frac"]) == pytest.approx(0.0, abs=1e-6)
    yj, aj = JM.moe_apply(_to_jax(w, jnp.float32), jnp.asarray(x), k, 8.0)
    np.testing.assert_allclose(float(aux["load_balance_loss"]),
                               float(aj["load_balance_loss"]), rtol=1e-5)
    _close(y, yj, 2e-4)


def test_moe_capacity_drops_tokens():
    d, ff, e, k = 8, 16, 4, 2
    w = _weights(4, d, ff, e)
    x = np.random.default_rng(4).standard_normal((2, 32, d), dtype=np.float32)
    _, aux = TM.moe_apply(_to_torch(w, torch.float32), torch.from_numpy(x),
                          top_k=k, capacity_factor=0.25)
    assert float(aux["dropped_frac"]) > 0.0
    _, aj = JM.moe_apply(_to_jax(w, jnp.float32), jnp.asarray(x), k, 0.25)
    assert float(aux["dropped_frac"]) == pytest.approx(
        float(aj["dropped_frac"]), abs=1e-6)


def test_moe_single_expert_equals_dense_ffn():
    """E=1, top-1, generous capacity → exactly the expert's SwiGLU."""
    d, ff = 8, 16
    w = _to_torch(_weights(5, d, ff, 1), torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, d), dtype=np.float32))
    y, _ = TM.moe_apply(w, x, top_k=1, capacity_factor=4.0)
    want = TL.mlp({"wi": w["wi"][0], "wo": w["wo"][0]}, x)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["sort", "einsum"])
def test_moe_grouping_preserves_semantics(mode):
    """G groups == 1 group when capacity is generous (same expert math)."""
    d, ff, e, k = 8, 16, 4, 2
    w = _to_torch(_weights(6, d, ff, e), torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 8, d), dtype=np.float32))
    y1, _ = TM.moe_apply(w, x, top_k=k, capacity_factor=8.0, n_groups=1,
                         mode=mode)
    y2, _ = TM.moe_apply(w, x, top_k=k, capacity_factor=8.0, n_groups=4,
                         mode=mode)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-5)


def test_moe_einsum_dispatch_equals_sort_dispatch():
    """Same outputs, same drop fraction (each path ranks its own way) and
    same gradients as the sort path; the gradients also equal JAX's."""
    d, ff, e, k = 8, 16, 4, 2
    w = _weights(7, d, ff, e)
    x = np.random.default_rng(7).standard_normal((2, 64, d), dtype=np.float32)
    tw, xt = _to_torch(w, torch.float32), torch.from_numpy(x)
    y1, _ = TM.moe_apply(tw, xt, k, 8.0, 2, "sort")
    y2, _ = TM.moe_apply(tw, xt, k, 8.0, 2, "einsum")
    torch.testing.assert_close(y1, y2, rtol=2e-4, atol=2e-5)
    _, a1 = TM.moe_apply(tw, xt, k, 0.5, 2, "sort")
    _, a2 = TM.moe_apply(tw, xt, k, 0.5, 2, "einsum")
    assert float(a1["dropped_frac"]) == pytest.approx(
        float(a2["dropped_frac"]), abs=1e-6)

    def grads(mode):
        leaves = {n: t.clone().requires_grad_() for n, t in tw.items()}
        y, _ = TM.moe_apply(leaves, xt, k, 8.0, 2, mode)
        return torch.autograd.grad((y ** 2).sum(), list(leaves.values()))

    jw = _to_jax(w, jnp.float32)
    jg = jax.grad(lambda p: jnp.sum(
        JM.moe_apply(p, jnp.asarray(x), k, 8.0, 2, "sort")[0] ** 2))(jw)
    for g1, g2, name in zip(grads("sort"), grads("einsum"), tw):
        torch.testing.assert_close(g1, g2, rtol=1e-3, atol=1e-4)
        _close(g1, jg[name], 2e-4)


# --------------------------------------------------------------------------- #
# the one-hot past the capacity; moe_ref; the combine's determinism
# --------------------------------------------------------------------------- #
def test_einsum_one_hot_past_the_capacity_is_a_zero_row():
    """Every token routed to the same two experts at C = 1: all but one
    assignment an expert sits at pos >= C, which F.one_hot would refuse."""
    d, ff, e, k = 8, 16, 4, 2
    w = _weights(8, d, ff, e)
    w["router"][:] = 0.0
    w["router"][0, :2] = [4.0, 2.0]          # experts 0 and 1 win
    x = np.abs(np.random.default_rng(8).standard_normal(
        (1, 16, d), dtype=np.float32)) + 0.1
    routing = {}
    yt, at = TM.moe_apply(_to_torch(w, torch.float32), torch.from_numpy(x),
                          k, 0.1, 1, "einsum", routing=routing)
    yj, aj = JM.moe_apply(_to_jax(w, jnp.float32), jnp.asarray(x), k, 0.1,
                          1, "einsum")
    assert routing["C"] == 1
    assert int(routing["keep"].sum()) == 2    # one token a slot of each
    _close(yt, yj, 2e-4)
    np.testing.assert_allclose(float(at["dropped_frac"]), 1 - 2 / 32,
                               atol=1e-6)
    assert float(aj["dropped_frac"]) == pytest.approx(1 - 2 / 32, abs=1e-6)
    assert bool((yt[0, 1:] == 0).all())       # tokens past C get nothing


@pytest.mark.parametrize("mode", ["sort", "einsum"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_ref_under_the_dispatch_routing(mode, capacity_factor):
    w = _to_torch(_weights(9), torch.float32)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 32, D), dtype=np.float32))
    routing = {}
    y, _ = TM.moe_apply(w, x, K, capacity_factor, 2, mode, routing=routing)
    flat = {k: routing[k].reshape(-1, K) for k in ("idx", "gate", "keep")}
    want = TM.moe_ref(w, x.reshape(-1, D), flat["idx"], flat["gate"],
                      flat["keep"])
    _close(y.reshape(-1, D), want, 2e-4)


def test_gather_combine_gives_the_same_bits_twice():
    w = _to_torch(_weights(10), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (4, 16, D), dtype=np.float32)).to(torch.bfloat16)
    a, _ = TM.moe_apply(w, x, K, 1.25, mode="sort")
    b, _ = TM.moe_apply(w, x, K, 1.25, mode="sort")
    assert torch.equal(a, b)


def test_routing_hook_pins_the_choices_and_rereads_the_gates():
    w = _to_torch(_weights(11), torch.float32)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 8, D), dtype=np.float32))
    seen = []
    pinned = torch.zeros((1, 8, K), dtype=torch.long)
    pinned[..., 1] = 3

    def hook(router, logits, idx):
        seen.append((router, logits, idx))
        return pinned

    TM.ROUTING_HOOK = hook
    try:
        routing = {}
        TM.moe_apply(w, x, K, 8.0, routing=routing)
    finally:
        TM.ROUTING_HOOK = None
    assert seen[0][0] is w["router"] and seen[0][2].shape == (1, 8, K)
    assert seen[0][1] is routing["logits"]
    assert torch.equal(routing["idx"], pinned)
    probs = torch.softmax(routing["logits"], dim=-1)
    want = probs[..., [0, 3]] / probs[..., [0, 3]].sum(-1, keepdim=True)
    torch.testing.assert_close(routing["gate"], want)


# --------------------------------------------------------------------------- #
# the router stays f32 in a bf16 model
# --------------------------------------------------------------------------- #
def test_bf16_moe_tree_keeps_an_f32_router():
    jc = jconfigs.get_config("moonshot-v1-16b-a3b").reduced(
        dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JLM(jc).init(jax.random.PRNGKey(0)))
    assert jp["layers"]["moe"]["router"].dtype == np.float32
    tp = params_from_numpy(jp, "bfloat16", device="cpu")
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["layers"]["moe"]["router"].numpy(),
                                  jp["layers"]["moe"]["router"])
    tc = configs.get_config("moonshot-v1-16b-a3b").reduced(dtype="bfloat16")
    drawn = LM(tc).init(torch.Generator().manual_seed(0))
    assert drawn["layers"]["moe"]["router"].dtype == torch.float32
    assert drawn["layers"]["moe"]["wo"].dtype == torch.bfloat16
    assert jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), jp) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix("torch.")), drawn)
