"""The port's training path on the CPU, held against the JAX package.

* ``LM.loss`` (the chunked cross-entropy, tail dropped) against the JAX
  ``LM.loss``, to 1e-5;
* one training step's loss and every gradient leaf against
  ``jax.value_and_grad`` of the JAX ``loss_fn``, from the same weights
  (``params_from_numpy``), with remat on and off and ``scan_chunks`` 0 and
  2; each leaf's error over its largest |ref|, to 2e-4;
* a moe model's step (reduced moonshot-v1-16b-a3b and qwen3-moe-235b-a22b,
  with and without capacity drops): the total loss ``ce + 1e-2 lb + 1e-3
  z``, its parts and every gradient leaf against ``jax.value_and_grad`` of
  the JAX step's ``loss_fn``, and ``make_train_step``'s metrics
  (``dropped_frac`` included) over 2 steps; each run also checks that no
  routing decision is a near-tie;
* a hybrid (reduced hymba-1.5b) and an ssm (reduced rwkv6-1.6b) model's
  step: the loss and every gradient leaf against ``jax.value_and_grad`` of
  the JAX step's ``loss_fn`` (at S 32, and at S 512, where the
  recurrences' chunk checkpoints nest in the per-layer remat), each leaf
  reached, and ``make_train_step``'s metrics over 2 steps; the SSM and
  RWKV leaves the reference initialises to zeros or ones are drawn first;
* ``adamw_update``, ``clip_by_global_norm`` and ``cosine_schedule``
  against the JAX functions; ``make_train_step`` for 3 steps in both
  packages on the same batches (losses to 1e-4 relative);
* ``SyntheticLMData`` bit for bit, ``PrefetchIterator``'s order;
* ``CheckpointStore``: round trip, keep-last-k, corruption, async save, bf16
  leaves, and a JAX-written checkpoint restored into the port's tree;
* the driver (``tests/test_substrates.py:120-170`` and
  ``tests/test_faults.py:133-147,457-530``, ported), the straggler
  re-dispatch's double step (the reference's behaviour, kept for parity),
  and the CLI.

Reduced configs are f32, where both packages' arithmetic is exact up to the
order of sums.  Every self-attention here runs the port's flash-attention
Function, whose CPU forward and backward are the kernels' plain versions.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import CheckpointStore as JStore
from repro.data import SyntheticLMData as JData
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import LM as JLM
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import cosine_schedule as j_cosine
from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
from repro_torch.data import PrefetchIterator, SyntheticLMData
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import LM
from repro_torch.models import moe as TM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule,
                               global_norm)
from repro_torch.runtime import (FaultInjector, FaultPlan,
                                 FaultTolerantDriver, InjectedFault,
                                 StragglerMonitor, as_injector)

torch.set_num_threads(1)

B, S = 2, 32


def _cfgs(**kw):
    """(JAX, port) reduced gemma3 configs: f32, window 8, 6 layers (one
    global)."""
    kw = {"n_layers": 6, **kw}
    return (jconfigs.get_config("gemma3-12b").reduced(**kw),
            configs.get_config("gemma3-12b").reduced(**kw))


def _jax_params(jc, seed=0):
    return JLM(jc).init(jax.random.PRNGKey(seed))


def _leaf_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _tokens(vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return ids, labels, mask


# --------------------------------------------------------------------------- #
# the loss and the gradients
# --------------------------------------------------------------------------- #
def test_chunked_loss_matches_jax_and_drops_the_tail():
    jc, tc = _cfgs()
    jp = _jax_params(jc)
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((B, S, jc.d_model), dtype=np.float32)
    _, labels, mask = _tokens(jc.vocab, 2)
    want = JLM(jc).loss(jp, jnp.asarray(hidden), jnp.asarray(labels),
                        jnp.asarray(mask), chunk=12)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    got = LM(tc).loss(tp, torch.from_numpy(hidden), torch.from_numpy(labels),
                      torch.from_numpy(mask), chunk=12)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    # 32 // 12 = 2 chunks: tokens 24.. take no part
    cut = mask.copy()
    cut[:, 24:] = 0
    again = LM(tc).loss(tp, torch.from_numpy(hidden),
                        torch.from_numpy(labels), torch.from_numpy(cut),
                        chunk=12)
    assert float(again) == float(got)
    no_mask = LM(tc).loss(tp, torch.from_numpy(hidden),
                          torch.from_numpy(labels), None, chunk=12)
    want_nm = JLM(jc).loss(jp, jnp.asarray(hidden), jnp.asarray(labels),
                           None, chunk=12)
    np.testing.assert_allclose(float(no_mask), float(want_nm), rtol=1e-5)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("scan_chunks", [0, 2])
def test_train_step_gradients_match_jax(remat, scan_chunks):
    jc, tc = _cfgs()
    jp = _jax_params(jc)
    ids, labels, mask = _tokens(jc.vocab, 3)
    jm = JLM(jc)

    def loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(ids), remat=remat,
                        scan_chunks=scan_chunks)
        return jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                       chunk=12)

    want_loss, want_g = jax.value_and_grad(loss_fn)(jp)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    flat, treedef = flatten(tp)
    for p in flat:
        p.requires_grad_(True)
    model = LM(tc)
    fa.reset_launches()
    h, _ = model.apply(tp, torch.from_numpy(ids).long(), remat=remat,
                       scan_chunks=scan_chunks)
    loss = model.loss(tp, h, torch.from_numpy(labels), torch.from_numpy(mask),
                      chunk=12)
    grads = unflatten(treedef, torch.autograd.grad(loss, flat))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got_l, want_l = leaves(grads), jax.tree.leaves(want_g)
    assert len(got_l) == len(want_l) == 10
    worst = max(_leaf_err(g.detach().numpy(), w)
                for g, w in zip(got_l, want_l))
    assert worst <= 2e-4, worst
    assert all(v == 0 for v in fa.LAUNCHES.values())      # CPU: plain


def _moe_cfgs(arch, capacity_factor):
    kw = {"moe_capacity_factor": capacity_factor}
    return (jconfigs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


# no routing decision may be a near-tie: a gap of 1e-5 between a token's
# k-th and (k+1)-th probability is ~100x the f32 difference of the two
# packages' probabilities
TIE_GAP = 1e-5


def _tie_free(gaps: list):
    """A routing hook that keeps every choice and collects the gap between
    each token's k-th and (k+1)-th probability."""
    def hook(router, logits, idx):
        top = torch.sort(torch.softmax(logits.detach(), -1), -1,
                         descending=True).values
        k = idx.shape[-1]
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return idx
    return hook


MOE_CASES = [("moonshot-v1-16b-a3b", 1.25), ("moonshot-v1-16b-a3b", 0.5),
             ("qwen3-moe-235b-a22b", 0.5)]


@pytest.mark.parametrize("arch,capacity_factor", MOE_CASES)
def test_moe_train_step_total_loss_and_gradients_match_jax(
        arch, capacity_factor):
    jc, tc = _moe_cfgs(arch, capacity_factor)
    jp = _jax_params(jc)
    ids, labels, mask = _tokens(jc.vocab, 5)
    jm = JLM(jc)

    def loss_fn(p):                 # the JAX make_train_step's loss_fn
        h, aux = jm.apply(p, jnp.asarray(ids), remat=True)
        ce = jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask), chunk=12)
        total = (ce + 1e-2 * aux["load_balance_loss"]
                 + 1e-3 * aux["router_z_loss"])
        return total, (ce, aux)

    (want_total, (want_ce, want_aux)), want_g = jax.value_and_grad(
        loss_fn, has_aux=True)(jp)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    batch = {"ids": torch.from_numpy(ids).long(),
             "labels": torch.from_numpy(labels).long(),
             "mask": torch.from_numpy(mask)}
    gaps = []
    TM.ROUTING_HOOK = _tie_free(gaps)
    try:
        ce, grads, aux = loss_and_grads(LM(tc), tp, batch, loss_chunk=12)
    finally:
        TM.ROUTING_HOOK = None
    assert len(gaps) == 2 * tc.n_layers and min(gaps) > TIE_GAP, gaps
    np.testing.assert_allclose(float(aux["total"]), float(want_total),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-5)
    np.testing.assert_allclose(
        float(aux["total"]), float(ce) + 1e-2 * float(
            aux["load_balance_loss"]) + 1e-3 * float(aux["router_z_loss"]),
        rtol=1e-6)
    for k in want_aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5, atol=1e-6)
    assert (capacity_factor < 1) == (float(aux["dropped_frac"]) > 0)
    want_l = jax.tree.leaves(want_g)
    assert len(grads) == len(want_l) == 11
    worst = max(_leaf_err(g.numpy(), w) for g, w in zip(grads, want_l))
    assert worst <= 2e-4, worst
    assert float(np.abs(np.asarray(
        want_g["layers"]["moe"]["router"])).max()) > 0


@pytest.mark.parametrize("arch,capacity_factor", MOE_CASES[1:])
def test_moe_make_train_step_reports_dropped_frac_as_jax(arch,
                                                         capacity_factor):
    jc, tc = _moe_cfgs(arch, capacity_factor)
    data = JData(vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)
    kw = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=16)
    _, jstep = j_make_train_step(jc, mesh=None, seq_parallel=False, **kw)
    jstep = jax.jit(jstep)
    jp = _jax_params(jc, seed=1)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    jstate = {"params": jp, "opt": j_adamw_init(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp)}
    _, tstep = make_train_step(tc, **kw)
    gaps = []
    for step in range(2):
        b = data.batch(step)
        jstate, jmet = jstep(jstate, {"ids": jnp.asarray(b.ids),
                                      "labels": jnp.asarray(b.labels),
                                      "mask": jnp.asarray(b.mask)})
        TM.ROUTING_HOOK = _tie_free(gaps)
        try:
            tstate, tmet = tstep(tstate, {
                "ids": torch.from_numpy(b.ids).long(),
                "labels": torch.from_numpy(b.labels),
                "mask": torch.from_numpy(b.mask)})
        finally:
            TM.ROUTING_HOOK = None
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm", "dropped_frac"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, atol=1e-6)
        assert float(tmet["dropped_frac"]) > 0
    # the weights themselves are not compared: AdamW's first step moves a
    # weight by ~lr * sign(g), so an element whose gradient is ~0 (one the
    # router barely reaches) lands on either side; the second step's loss
    # and gradient norm above are what the first step's weights give
    assert min(gaps) > TIE_GAP, gaps


# the leaves ``ssm_init`` and ``rwkv_init`` set to zeros or ones, drawn
# instead: name -> (low, high) of a uniform draw
STATE_LEAF_DRAWS = {"dt_bias": (-2.0, 0.0), "A_log": (-1.0, 1.0),
                    "D": (0.5, 1.5), "mu": (0.0, 1.0), "mu_c": (0.0, 1.0),
                    "w_bias": (-3.0, 0.0), "u": (-0.5, 0.5),
                    "ln_scale": (0.5, 1.5)}


def _recurrent_params(jc, seed):
    """JAX ``LM.init`` weights with the ssm / rwkv state leaves drawn."""
    p = _jax_params(jc, seed)
    rng = np.random.default_rng(seed + 100)
    blk = "rwkv" if jc.rwkv else "ssm"
    p["layers"][blk] = {
        k: (jnp.asarray(rng.uniform(*STATE_LEAF_DRAWS[k], v.shape),
                        v.dtype) if k in STATE_LEAF_DRAWS else v)
        for k, v in p["layers"][blk].items()}
    return p


@pytest.mark.parametrize("seq", [32, 512])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_recurrent_train_step_loss_and_gradients_match_jax(arch, seq):
    jc, tc = (jconfigs.get_config(arch).reduced(),
              configs.get_config(arch).reduced())
    jp = _recurrent_params(jc, 0)
    rng = np.random.default_rng(7)
    ids, labels = (rng.integers(0, jc.vocab, (B, seq)).astype(np.int32)
                   for _ in range(2))
    mask = (rng.random((B, seq)) < 0.8).astype(np.float32)
    jm = JLM(jc)

    def loss_fn(p):                 # the JAX make_train_step's loss_fn
        h, _ = jm.apply(p, jnp.asarray(ids), remat=True)
        return jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                       chunk=12)

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(jp)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    ce, grads, aux = loss_and_grads(
        LM(tc), tp, {"ids": torch.from_numpy(ids).long(),
                     "labels": torch.from_numpy(labels).long(),
                     "mask": torch.from_numpy(mask)}, loss_chunk=12)
    np.testing.assert_allclose(float(ce), float(want_loss), rtol=1e-5)
    assert float(aux["total"]) == float(ce)           # no aux term
    want_l = jax.tree.leaves(want_g)
    assert len(grads) == len(want_l) == (19 if jc.rwkv else 18)
    worst = max(_leaf_err(g.numpy(), w) for g, w in zip(grads, want_l))
    assert worst <= 2e-4, worst
    # every leaf is reached: the JAX tree has no unused leaf
    assert all(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_recurrent_make_train_step_matches_jax(arch):
    jc, tc = (jconfigs.get_config(arch).reduced(),
              configs.get_config(arch).reduced())
    data = JData(vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)
    kw = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=16)
    _, jstep = j_make_train_step(jc, mesh=None, seq_parallel=False, **kw)
    jstep = jax.jit(jstep)
    jp = _recurrent_params(jc, 1)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    jstate = {"params": jp, "opt": j_adamw_init(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp)}
    _, tstep = make_train_step(tc, **kw)
    for step in range(2):
        b = data.batch(step)
        jstate, jmet = jstep(jstate, {"ids": jnp.asarray(b.ids),
                                      "labels": jnp.asarray(b.labels),
                                      "mask": jnp.asarray(b.mask)})
        tstate, tmet = tstep(tstate, {"ids": torch.from_numpy(b.ids).long(),
                                      "labels": torch.from_numpy(b.labels),
                                      "mask": torch.from_numpy(b.mask)})
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """Per-layer remat runs every attention twice (forward + recompute),
    without remat once.  scan_chunks=2 adds the chunk's recompute, which
    stops early once it has what its backward needs (the input of the
    chunk's last layer), so one more run of each chunk's first layer;
    scan_chunks=3 does not divide 4 layers and is ignored."""
    _, tc = _cfgs(n_layers=4)
    model = LM(tc)
    tp = model.init(torch.Generator("cpu").manual_seed(0))
    calls = []
    real = fa.flash_attention_fwd

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    ids = torch.from_numpy(_tokens(tc.vocab, 4)[0]).long()
    for remat, chunks, expect in ((False, 0, 4), (True, 0, 8), (True, 2, 10),
                                  (True, 3, 8)):
        calls.clear()
        flat, _ = flatten(tp)
        for p in flat:
            p.requires_grad_(True)
        h, _ = model.apply(tp, ids, remat=remat, scan_chunks=chunks)
        torch.autograd.grad(h.float().square().sum(), flat)
        assert len(calls) == expect, (remat, chunks, len(calls))


def test_logits_product_and_its_backward_keep_jax_arithmetic_in_bf16():
    """bf16 h and table: the loss's logits product (``logits_f32``) and the
    serving head (``lm_logits``) against the JAX einsum with
    ``preferred_element_type`` f32, to 1e-6 of the largest; the backward
    against ``jax.vjp`` of that einsum, whose transpose rule multiplies the
    f32 cotangent by the other bf16 operand.  The gradients are within one
    bf16 ulp of JAX's and equal on all but 1% of their elements (rounding
    the cotangent to bf16 first moves about 40% of them)."""
    import repro.models.layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(5)
    N, d, V = 24, 64, 512
    h = jnp.asarray(rng.standard_normal((N, d)), jnp.bfloat16)
    table = jnp.asarray(rng.standard_normal((V, d)) * 0.05, jnp.bfloat16)
    g = rng.standard_normal((N, V)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "nd,vd->nv", a, b, preferred_element_type=jnp.float32), h, table)
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g))]
    th, tt = (torch.from_numpy(np.array(a.astype(jnp.float32))
                               ).bfloat16().requires_grad_()
              for a in (h, table))
    got = TL.logits_f32(th, tt)
    assert got.dtype == torch.float32
    scale = float(np.abs(out).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-6 * scale)
    served = TL.lm_logits({"table": tt.detach()}, th.detach()[None], V - 12)
    np.testing.assert_allclose(
        served.numpy(), np.asarray(JL.lm_logits({"table": table}, h[None],
                                                V - 12)),
        rtol=0, atol=1e-6 * scale)
    for a, w in zip(torch.autograd.grad(got, (th, tt), torch.from_numpy(g)),
                    want):
        assert a.dtype == torch.bfloat16
        a = a.float().numpy()
        rms = np.sqrt(np.square(w).mean())
        assert (np.abs(a - w) <= 2.0**-7 * np.abs(w) + 2.0**-8 * rms).all()
        assert (a != w).mean() <= 0.01


def test_bf16_terms_sum_to_their_f32_input_exactly():
    from repro_torch.models.layers import bf16_terms

    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal((300, 200))
                          * np.exp(rng.standard_normal((300, 200)) * 5)
                          ).astype(np.float32))
    t = bf16_terms(x)
    assert t.shape == (3, 300, 200) and t.dtype == torch.bfloat16
    assert torch.equal((t[0].float() + t[1].float()) + t[2].float(), x)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def _opt_case(seed, big):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}
    mk = lambda s: rng.standard_normal(s, dtype=np.float32)
    params = jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda a: mk(a.shape) * (50.0 if big else 0.01),
                         params)
    m = jax.tree.map(lambda a: mk(a.shape) * 0.1, params)
    v = jax.tree.map(lambda a: np.abs(mk(a.shape)) * 0.1, params)
    return params, grads, m, v


@pytest.mark.parametrize("big", [True, False], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(big):
    params, grads, m, v = _opt_case(9, big)
    sched_j, sched_t = j_cosine(3e-3, 5, 50), cosine_schedule(3e-3, 5, 50)
    jstate = j_adamw_init(params)._replace(step=jnp.asarray(3, jnp.int32),
                                           m=jax.tree.map(jnp.asarray, m),
                                           v=jax.tree.map(jnp.asarray, v))
    jp, jo, jm = j_adamw_update(jax.tree.map(jnp.asarray, grads), jstate,
                                jax.tree.map(jnp.asarray, params),
                                lr=sched_j)
    tt = lambda tree: tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    tparams = tt(params)
    tstate = AdamWState(torch.tensor(3, dtype=torch.int32), tt(m), tt(v))
    tp, to, tm = adamw_update(tt(grads), tstate, tparams, lr=sched_t)
    assert tp is tparams                      # in place
    assert to.step.dtype == torch.int32 and int(to.step) == 4
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    for got, want in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                       atol=1e-9)


def test_adamw_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.tensor([1.0, -2.0, 0.5], dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.m["w"].dtype == torch.float32 and int(st.step) == 0
    g = {"w": torch.tensor([0.3, 0.1, -0.2], dtype=torch.bfloat16)}
    jp = {"w": jnp.asarray([1.0, -2.0, 0.5], jnp.bfloat16)}
    jg = {"w": jnp.asarray([0.3, 0.1, -0.2], jnp.bfloat16)}
    want, jst, _ = j_adamw_update(jg, j_adamw_init(jp), jp, lr=1e-2)
    got, tst, _ = adamw_update(g, st, p, lr=1e-2)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(want["w"], np.float32))
    np.testing.assert_allclose(tst.v["w"].numpy(), np.asarray(jst.v["w"]),
                               rtol=1e-6)


def test_clip_and_schedule_match_jax():
    _, grads, _, _ = _opt_case(4, True)
    want, wnorm = j_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    tg = tree_map(lambda a: torch.from_numpy(a.copy()), grads)
    got, norm = clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(got)), 1.0, rtol=1e-5)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    js, ts = j_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(ts(torch.tensor(step))),
                                   float(js(step)), rtol=1e-6, atol=1e-12)


# --------------------------------------------------------------------------- #
# three steps of make_train_step in both packages
# --------------------------------------------------------------------------- #
def test_make_train_step_three_steps_match_jax():
    jc, tc = _cfgs(n_layers=2)
    data = JData(vocab=jc.vocab, seq_len=S, global_batch=B, seed=0)
    kw = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=16)
    _, jstep = j_make_train_step(jc, mesh=None, seq_parallel=False, **kw)
    jstep = jax.jit(jstep)
    jp = _jax_params(jc, seed=1)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    jstate = {"params": jp, "opt": j_adamw_init(jp)}
    tstate = {"params": tp, "opt": adamw_init(tp)}
    _, tstep = make_train_step(tc, **kw)
    for step in range(3):
        b = data.batch(step)
        jstate, jmet = jstep(jstate, {"ids": jnp.asarray(b.ids),
                                      "labels": jnp.asarray(b.labels),
                                      "mask": jnp.asarray(b.mask)})
        tstate, tmet = tstep(tstate, {"ids": torch.from_numpy(b.ids).long(),
                                      "labels": torch.from_numpy(b.labels),
                                      "mask": torch.from_numpy(b.mask)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=1e-6)
    assert not any(p.requires_grad for p in leaves(tstate["params"]))
    worst = max(_leaf_err(g.numpy(), w) for g, w in zip(
        leaves(tstate["params"]), jax.tree.leaves(jstate["params"])))
    assert worst <= 1e-4, worst


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
def test_synthetic_data_is_the_jax_stream_bit_for_bit():
    for vocab, seq, batch, seed in ((262144, 64, 4, 0), (11, 5, 3, 7)):
        jd = JData(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
        td = SyntheticLMData(vocab=vocab, seq_len=seq, global_batch=batch,
                             seed=seed)
        np.testing.assert_array_equal(td.motifs, jd.motifs)
        for step in (0, 1, 17):
            a, b = td.batch(step), jd.batch(step)
            for f in ("ids", "labels", "mask"):
                x, y = getattr(a, f), np.asarray(getattr(b, f))
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        assert td.local_slice() == (0, batch)
        np.testing.assert_array_equal(td.batch(3, local_only=True).ids,
                                      jd.batch(3, local_only=True).ids)


def test_prefetch_iterator_keeps_the_order():
    td = SyntheticLMData(vocab=50, seq_len=8, global_batch=2, seed=1)
    it = PrefetchIterator(iter(td), depth=2)
    for step in range(5):
        np.testing.assert_array_equal(next(it).ids, td.batch(step).ids)
    assert list(PrefetchIterator(iter(range(7)), depth=3)) == list(range(7))


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def _state_tree():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((3, 4), generator=g),
              "emb": torch.randn((5, 2), generator=g).bfloat16(),
              "n": {"s": torch.randn((4,), generator=g)}}
    return {"params": params, "opt": adamw_init(params)}


def test_checkpoint_round_trip_with_bf16_leaves_and_keep_last(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = _state_tree()
    for step in (1, 2, 3):
        store.save(step, tree, {"next_step": step})
    assert store.steps() == [2, 3] and store.latest_step() == 3
    like = tree_map(torch.zeros_like, tree)
    got, extra = store.restore(None, like=like)
    assert extra == {"next_step": 3}
    assert isinstance(got["opt"], AdamWState)
    for g, w in zip(leaves(got), leaves(tree)):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    manifest = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    dtypes = [m["dtype"] for m in manifest["leaves"]]
    # opt (step, m, v) before params; dict keys sorted: emb, n.s, w
    assert dtypes == ["int32"] + ["float32"] * 6 + ["bfloat16", "float32",
                                                     "float32"]
    with pytest.raises(ValueError, match="incompatible tree"):
        store.restore(3, like={"w": torch.zeros(1)})
    bad = tree_map(torch.zeros_like, tree)
    bad["params"]["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        store.restore(3, like=bad)


def test_checkpoint_detects_corruption(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(1000.0)}
    path = store.save(1, tree)
    f = os.path.join(path, "arrays.npz")
    data = bytearray(open(f, "rb").read())
    data[-20] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(Exception):
        store.restore(1, like=tree)


def test_checkpoint_async_save_keeps_the_state_of_its_call(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"w": torch.arange(4.0)}
    store.save_async(5, tree, {"next_step": 5})
    tree["w"].add_(100.0)                     # the next step, in place
    store.wait()
    got, extra = store.restore(None, like=tree)
    assert extra == {"next_step": 5}
    torch.testing.assert_close(got["w"], torch.arange(4.0))


def test_a_jax_checkpoint_restores_into_the_ports_tree(tmp_path):
    """jax.tree.flatten's order and the bf16 byte views are shared, so the
    port reads what the JAX store wrote."""
    jc, tc = _cfgs(n_layers=2, dtype="bfloat16")
    jp = _jax_params(jc)
    jtree = {"params": jp, "opt": j_adamw_init(jp)._replace(
        step=jnp.asarray(7, jnp.int32))}
    JStore(str(tmp_path)).save(7, jtree, {"next_step": 7})
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    like = {"params": tree_map(torch.zeros_like, tp),
            "opt": adamw_init(tp)}
    got, extra = CheckpointStore(str(tmp_path)).restore(None, like=like)
    assert extra == {"next_step": 7} and int(got["opt"].step) == 7
    for g, w in zip(leaves(got["params"]), leaves(tp)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # and the port's checkpoint of the same tree is byte-for-byte the same
    CheckpointStore(str(tmp_path / "port")).save(7, {
        "params": tp, "opt": got["opt"]}, {"next_step": 7})
    mine = json.load(open(tmp_path / "port" / "step_00000007" /
                          "manifest.json"))
    theirs = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert mine["leaves"] == theirs["leaves"]


def test_the_ports_checkpoint_restores_into_the_jax_tree(tmp_path):
    """The other way: the JAX store's restore reads what the port's store
    wrote (bf16 params, the AdamW moments and step), each leaf equal."""
    jc, tc = _cfgs(n_layers=2, dtype="bfloat16")
    jp = _jax_params(jc)
    tp = params_from_numpy(jp, tc.dtype, device="cpu")
    opt = adamw_init(tp)
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32),
                       m=tree_map(lambda a: torch.full_like(a, 0.25), opt.m),
                       v=tree_map(lambda a: torch.full_like(a, 0.5), opt.v))
    CheckpointStore(str(tmp_path)).save(7, {"params": tp, "opt": opt},
                                        {"next_step": 7})
    like = {"params": jax.tree.map(jnp.zeros_like, jp),
            "opt": j_adamw_init(jp)}
    got, extra = JStore(str(tmp_path)).restore(None, like=like)
    assert extra == {"next_step": 7} and int(got["opt"].step) == 7
    for g, w in zip(jax.tree.leaves(got["params"]), leaves(tp)):
        assert str(g.dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      w.float().numpy())
    for g, w in zip(jax.tree.leaves(got["opt"].m), leaves(opt.m)):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      w.float().numpy())
    for g, w in zip(jax.tree.leaves(got["opt"].v), leaves(opt.v)):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      w.float().numpy())


# --------------------------------------------------------------------------- #
# the fault-tolerant driver
# --------------------------------------------------------------------------- #
class _ToyData:
    def __init__(self):
        self.d = SyntheticLMData(vocab=11, seq_len=4, global_batch=2, seed=0)

    def batch(self, step):
        return self.d.batch(step)


def _toy_step(state, batch):
    w = state["w"] - 0.1
    return {"w": w}, {"loss": torch.sum(w * w)}


def test_driver_restarts_from_checkpoint(tmp_path):
    store = CheckpointStore(str(tmp_path))
    drv = FaultTolerantDriver(_toy_step, store, _ToyData(), ckpt_every=5,
                              async_ckpt=False,
                              faults=FaultPlan().fail_step([7]))
    state, res = drv.run({"w": torch.ones(3)}, n_steps=12)
    assert res.restarts == 1 and res.steps_done == 12
    # resumed from step 5: total applied updates == 12
    np.testing.assert_allclose(state["w"].numpy(), np.ones(3) - 0.1 * 12,
                               rtol=1e-5)


def test_driver_resume_across_runs(tmp_path):
    store = CheckpointStore(str(tmp_path))
    drv = FaultTolerantDriver(_toy_step, store, _ToyData(), ckpt_every=5,
                              async_ckpt=False)
    drv.run({"w": torch.ones(3)}, n_steps=5)
    drv2 = FaultTolerantDriver(_toy_step, store, _ToyData(), ckpt_every=5)
    state, res2 = drv2.run({"w": torch.ones(3)}, n_steps=10)
    assert res2.steps_done == 10
    np.testing.assert_allclose(state["w"].numpy(), np.ones(3) - 0.1 * 10,
                               atol=1e-6)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(10):
        assert not mon.record(i, 1.0)
    assert mon.record(10, 10.0)
    assert mon.flagged and mon.flagged[0][0] == 10


def test_straggler_redispatch_applies_the_step_twice_as_the_reference(
        tmp_path):
    """The reference re-dispatches a straggler with the state the step
    already returned (``src/repro/runtime/driver.py:760-767``), so that
    step's update lands twice; the port keeps this for parity."""
    slow = {10}

    class Mon(StragglerMonitor):
        def record(self, step, dt):
            super().record(step, dt)
            return step in slow

    store = CheckpointStore(str(tmp_path))
    drv = FaultTolerantDriver(_toy_step, store, _ToyData(), ckpt_every=100,
                              async_ckpt=False, straggler=Mon(),
                              redispatch_stragglers=True)
    state, res = drv.run({"w": torch.ones(3)}, n_steps=12)
    assert res.straggler_redispatches == 1 and res.steps_done == 12
    np.testing.assert_allclose(state["w"].numpy(), np.ones(3) - 0.1 * 13,
                               rtol=1e-5)


def test_fail_step_fires_once_and_as_injector_normalizes():
    inj = FaultPlan().fail_step([3]).build()
    inj.on_step(2)
    with pytest.raises(InjectedFault):
        inj.on_step(3)
    inj.on_step(3)
    assert as_injector(None) is None
    assert as_injector(inj) is inj
    assert isinstance(as_injector(FaultPlan()), FaultInjector)
    with pytest.raises(TypeError, match="FaultPlan or FaultInjector"):
        as_injector(lambda s: None)


def test_driver_faults_and_fail_hook_are_exclusive(tmp_path):
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(ValueError, match="not both"):
        FaultTolerantDriver(lambda s, b: (s, {"loss": 0.0}), store, None,
                            faults=FaultPlan(), fail_hook=lambda s: None)


def test_driver_replay_does_not_double_count_losses(tmp_path):
    class Data:
        def batch(self, step):
            return float(step)

    store = CheckpointStore(str(tmp_path))
    drv = FaultTolerantDriver(_toy_step, store, Data(), ckpt_every=4,
                              async_ckpt=False,
                              faults=FaultPlan().fail_step([6]))
    state, res = drv.run({"w": torch.ones(3)}, n_steps=10)
    assert res.restarts == 1 and res.steps_done == 10
    assert len(res.losses) == 10
    np.testing.assert_allclose(state["w"].numpy(), np.ones(3) - 1.0,
                               atol=1e-6)


def test_driver_legacy_fail_hook_still_supported(tmp_path):
    class Data:
        def batch(self, step):
            return float(step)

    armed = {"on": True}

    def hook(step):
        if step == 3 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("legacy injected failure")

    store = CheckpointStore(str(tmp_path))
    drv = FaultTolerantDriver(_toy_step, store, Data(), ckpt_every=2,
                              async_ckpt=False, fail_hook=hook)
    _, res = drv.run({"w": torch.ones(2)}, n_steps=6)
    assert res.restarts == 1 and res.steps_done == 6


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_cli_trains_on_the_cpu_and_the_loss_decreases(tmp_path, capsys):
    res = ttrain.main(["--device", "cpu", "--reduced", "--steps", "30",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    assert res.steps_done == 30 and res.restarts == 0
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert all(np.isfinite(res.losses))
    out = capsys.readouterr().out
    assert "tok/s" in out and "restarts=0" in out and "on cpu" in out
    assert CheckpointStore(str(tmp_path / "gemma3-12b")).steps() == [20, 30]


def test_cli_trains_the_vlm_on_the_cpu(tmp_path, capsys):
    res = ttrain.main(["--arch", "llama-3.2-vision-11b", "--device", "cpu",
                       "--reduced", "--steps", "12", "--ckpt-dir",
                       str(tmp_path), "--ckpt-every", "100"])
    assert res.steps_done == 12 and res.restarts == 0
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert "arch=llama-3.2-vision-11b" in capsys.readouterr().out


def test_cli_without_a_card_refuses_to_run(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "2", "--ckpt-dir",
                     str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.build(_cfgs(n_layers=2)[1], 2, 1e-3, 8, 2)


def test_tree_flattens_in_jax_order():
    jc, tc = _cfgs(n_layers=2)
    jp = _jax_params(jc)
    tree = {"params": params_from_numpy(jp, tc.dtype, device="cpu")}
    tree["opt"] = adamw_init(tree["params"])
    jtree = {"params": jp, "opt": j_adamw_init(jp)}
    got = [tuple(x.shape) for x in leaves(tree)]
    want = [tuple(x.shape) for x in jax.tree.leaves(jtree)]
    assert got == want
    flat, d = flatten(tree)
    again = unflatten(d, flat)
    assert isinstance(again["opt"], AdamWState)
    assert all(a is b for a, b in zip(leaves(again), flat))
