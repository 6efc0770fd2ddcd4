"""The vlm family (llama-3.2-vision-11b) under a model axis on the CPU,
held against the JAX package.

The port's serve steps (weights by ``param_shardings_serving``, the
``{"self", "cross"}`` cache by ``cache_shardings``) and train step (params
by ``param_shardings``, moments by ``opt_shardings``) on ``(1, model)``
gloo meshes of ``run_on_local_mesh``, against the JAX package's unsharded
``make_prefill_step`` / ``make_decode_step``, ``loss_fn`` under
``jax.value_and_grad`` and ``make_train_step(cfg, None)`` on the same
numpy-seeded f32 weights and image embeddings (GSPMD changes no value; the
JAX trainer's zero embeddings would give the cross layers no gradient):

* the reduced config of ``tests/test_torch_vlm.py`` (d 64, 4 heads x 16
  over 2 kv heads, 16 image rows, 2 groups of 1 self + 1 cross layer) on 2
  ranks (2 heads and 1 kv head a rank: each rank's k/v re-laid into the
  caches, which keep both kv heads at half of head_dim) and on 4 (1 head
  a rank; the 2 kv heads stay whole by the guard, the caches keep a
  quarter of head_dim), and with ``cross_attn_every`` 3 (2 groups of 2
  self + 1 cross layer: the ``[G, per, ...]`` stacks' order) on 2 ranks;
* the prefill step's logits, 3 teacher-forced decode steps' logits and
  every cache leaf (``self`` k/v, ``cross`` ck/cv) reassembled from the
  ranks' shards, within 2e-4 of max |reference|; each rank's shards at
  the ``cache_shardings`` local shapes (head_dim split, every kv head) and
  its weights at ``param_shardings_serving``'s;
* ``_unstack`` of a ``[G, per, ...]`` DTensor stack (the self layers'
  weights and the self cache): DTensors in the order g * per + j, views
  of the stack's local tensor at its bounds;
* with ``seq_parallel`` on and off: the loss (rtol 1e-5) and every
  gradient leaf reassembled within 2e-4 of max |reference| (the cross
  layers' among them, nonzero), every leaf held whole equal on every
  rank; two ``make_train_step`` steps and two steps carried on the
  ranks, held as ``tests/test_torch_tp_recurrent.py`` holds them.

One spawn a mesh, each with a deadline.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as JST
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import AdamWState, adamw_init

from test_torch_tp_recurrent import _jax_state
from test_torch_tp_train import _err, _param_err, _paths, _port_paths, _whole
from torch_spmd_ranks import tp_family_rank

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b"
B, S, N, CHUNK = 2, 16, 3, 8
KW = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=CHUNK)
# name -> (reduced() overrides, the meshes' model axes)
CONFIGS = {"vlm": ({}, (2, 4)),
           "vlm-every3": (dict(cross_attn_every=3, n_layers=6), (2,))}
CASES = [(n, m) for n, (_, ms) in CONFIGS.items() for m in ms]
IDS = [f"{n}-model{m}" for n, m in CASES]
SP_CASES = [(n, m, sp) for n, m in CASES for sp in (True, False)]
SP_IDS = [f"{n}-model{m}-{'seq' if sp else 'noseq'}"
          for n, m, sp in SP_CASES]


def _jax_reference(name: str, seed: int) -> dict:
    """One config's JAX runs: serving (prefill logits, N decode steps'
    logits, the cache after them), the loss and gradients on one batch,
    and two train steps; every batch with image embeddings drawn."""
    over, _ = CONFIGS[name]
    jc, cfg = jget_config(ARCH).reduced(**over), get_config(ARCH).reduced(
        **over)
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 200)

    def img():
        return rng.standard_normal(
            (B, jc.n_img_tokens, jc.d_model)).astype(np.float32)

    ids, image = rng.integers(0, jc.vocab, (B, S)), img()
    steps = rng.integers(0, jc.vocab, (B, N))
    draws = [(rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              (rng.random((B, S)) < 0.8).astype(np.float32), img())
             for _ in range(2)]

    def jbatch(i, lb, m, im):
        return {"ids": jnp.asarray(i), "labels": jnp.asarray(lb),
                "mask": jnp.asarray(m), "img_embeds": jnp.asarray(im)}

    _, jpre = JST.make_prefill_step(jc)
    logits = np.asarray(jpre(jp, {"ids": jnp.asarray(ids),
                                  "img_embeds": jnp.asarray(image)}))
    jcache = jm.init_cache(B, S + N)
    _, jcache = jm.prefill(jp, jnp.asarray(ids), jcache,
                           img_embeds=jnp.asarray(image))
    _, jdec = JST.make_decode_step(jc)
    jdec = jax.jit(jdec)
    dec = []
    for j in range(N):
        lg, jcache = jdec(jp, jcache, {"ids": jnp.asarray(steps[:, j:j + 1]),
                                       "pos": S + j})
        dec.append(np.asarray(lg))

    ids0, labels0, mask0, img0 = draws[0]

    def loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(ids0), img_embeds=jnp.asarray(img0),
                        remat=True)
        return jm.loss(p, h, jnp.asarray(labels0), jnp.asarray(mask0),
                       chunk=CHUNK)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    _, jstep = JST.make_train_step(jc, None, seq_parallel=False, **KW)
    jstep = jax.jit(jstep)
    state, metrics, after = {"params": jp, "opt": j_adamw_init(jp)}, [], []
    for d in draws:
        state, met = jstep(state, jbatch(*d))
        metrics.append({k: float(v) for k, v in met.items()})
        after.append({k: _port_paths(v) for k, v in
                      (("params", state["params"]),
                       ("m", state["opt"].m), ("v", state["opt"].v))})
        if len(after) == 1:
            mid = state

    batches = [{"ids": torch.from_numpy(i).long(),
                "labels": torch.from_numpy(lb), "mask": torch.from_numpy(m),
                "img_embeds": torch.from_numpy(im)}
               for i, lb, m, im in draws]

    def port(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree), cfg.dtype,
                                 device="cpu")

    params = port(jp)
    start1 = (port(mid["params"]), AdamWState(
        step=torch.tensor(int(mid["opt"].step), dtype=torch.int32),
        m=port(mid["opt"].m), v=port(mid["opt"].v)))
    job = (cfg, params, torch.from_numpy(ids).long(),
           torch.from_numpy(steps).long(), batches[0], batches, start1,
           torch.from_numpy(image))
    return {"cfg": cfg, "params": params, "job": job, "logits": logits,
            "decode": dec, "cache": _port_paths(jcache),
            "loss": float(loss), "grads": _port_paths(grads),
            "metrics": metrics, "after": after, "jstep": jstep,
            "jbatch": jbatch(*draws[1]), "jstate": mid}


@pytest.fixture(scope="module")
def reference():
    return {name: _jax_reference(name, seed)
            for seed, name in enumerate(CONFIGS)}


_RUNS: dict = {}


def _ranks(ref, model: int) -> list:
    """Every rank's results on a (1, model) mesh, for the configs run on
    it (one spawn a mesh)."""
    if model not in _RUNS:
        jobs = {n: ref[n]["job"] for n, (_, ms) in CONFIGS.items()
                if model in ms}
        _RUNS[model] = TMESH.run_on_local_mesh(
            (1, model), ("data", "model"), tp_family_rank, jobs, KW,
            device="cpu", timeout=600)
    return _RUNS[model]


@pytest.mark.parametrize("name,model", CASES, ids=IDS)
def test_tp_vlm_serving_matches_jax_unsharded(reference, name, model):
    ref = reference[name]
    cfg = ref["cfg"]
    res = [r[name]["serve"] for r in _ranks(reference, model)]
    layout = TMESH.MeshLayout((1, model), ("data", "model"))
    for r in res:
        assert r["all_dtensors"]
        assert _err(r["logits"], ref["logits"]) <= 2e-4
        assert len(r["decode"]) == N
        for got, want in zip(r["decode"], ref["decode"]):
            assert _err(got, want) <= 2e-4
    cache = _whole(res, lambda r: r["cache"])
    assert set(cache) == {"self/k", "self/v", "cross/ck", "cross/cv"}
    assert set(cache) == set(ref["cache"])
    errs = {p: _err(cache[p], ref["cache"][p]) for p in cache}
    assert max(errs.values()) <= 2e-4, errs
    # the weights at their serving specs' local shapes: half (a quarter)
    # of the heads; the kv heads split on 2 ranks, whole on 4
    specs = _paths(TS.param_shardings_serving(layout, ref["params"]))
    for r in res:
        for path, (local, whole) in r["shapes"].items():
            assert local == TS.local_shape(layout, specs[path].spec,
                                           whole), path
    G, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    kv = KV // model if KV % model == 0 else KV
    shapes = res[0]["shapes"]
    assert shapes["layers/attn/wq"][0] == (G, per, d, H // model, hd)
    assert shapes["cross/attn/wk"][0] == (G, d, kv, hd)
    assert shapes["cross/attn/wo"][0] == (G, H * hd // model, d)
    # the caches in the JAX layout: every kv head at a part of head_dim
    whole = TST.abstract_cache(cfg, B, S + N)
    cspecs = _paths(TS.cache_shardings(layout, cfg, whole))
    for r in res:
        for path, (local, _, shape) in r["cache"].items():
            assert tuple(local.shape) == TS.local_shape(
                layout, cspecs[path].spec, shape), path
        assert tuple(r["cache"]["self/k"][0].shape) == (
            G, per, B, S + N, KV, hd // model)
        assert tuple(r["cache"]["cross/ck"][0].shape) == (
            G, B, cfg.n_img_tokens, KV, hd // model)


@pytest.mark.parametrize("name,model", CASES, ids=IDS)
def test_tp_vlm_unstack_gives_views_of_the_local_stack(reference, name,
                                                       model):
    for r in _ranks(reference, model):
        assert r[name]["unstack"] == {"params": True, "cache": True}


@pytest.mark.parametrize("name,model,sp", SP_CASES, ids=SP_IDS)
def test_tp_vlm_loss_and_gradients_match_jax(reference, name, model, sp):
    ref = reference[name]
    res = [r[name] for r in _ranks(reference, model)]
    for r in res:
        np.testing.assert_allclose(r["loss"][sp], ref["loss"], rtol=1e-5)
        assert r["laid_out"][sp]
    got = _whole(res, lambda r: r["grads"][sp])     # replicas equal
    assert set(got) == set(ref["grads"])
    errs = {p: _err(got[p], ref["grads"][p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs
    for n in ("wq", "wk", "wv", "wo"):              # the cross layers'
        assert float(got[f"cross/attn/{n}"].abs().max()) > 0


@pytest.mark.parametrize("name,model,sp", SP_CASES, ids=SP_IDS)
def test_tp_vlm_two_train_steps_match_jax(reference, name, model, sp):
    """Step 1 from the shared start, step 2 from JAX's state after step 1,
    each held to JAX's step (``tests/test_torch_tp_recurrent.py``)."""
    ref = reference[name]
    res = [r[name] for r in _ranks(reference, model)]
    layout = TMESH.MeshLayout((1, model), ("data", "model"))
    specs = _paths(TS.opt_shardings(layout, adamw_init(ref["params"]),
                                    ref["params"]).m)
    for i in range(2):
        for r in res:
            st = r["steps"][sp][i]
            assert st["step"] == i + 1 and st["step_plain"]
            assert st["moments_laid_out"]
            (got,) = st["metrics"]
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], ref["metrics"][i][k],
                                           rtol=1e-4)
            for n in ("m", "v"):
                for path, (local, _, shape) in st[n].items():
                    assert tuple(local.shape) == TS.local_shape(
                        layout, specs[path].spec, shape), (n, path)
        norms = {r["steps"][sp][i]["metrics"][0]["grad_norm"] for r in res}
        assert len(norms) == 1, norms       # one number on every rank
        want = ref["after"][i]
        got = _whole(res, lambda r: r["steps"][sp][i]["params"])
        if i == 0:
            errs = {p: _param_err(got[p], want["params"][p], ref["grads"][p])
                    for p in got}
            assert max(errs.values()) <= 1e-4, errs
        for n in ("m", "v"):
            got = _whole(res, lambda r: r["steps"][sp][i][n])
            errs = {p: _err(got[p], want[n][p]) for p in got}
            assert max(errs.values()) <= 1e-4, (i, n, errs)


@pytest.mark.parametrize("name,model,sp", SP_CASES, ids=SP_IDS)
def test_tp_vlm_carried_second_step_is_jax_step_from_the_first(
        reference, name, model, sp):
    """Two steps carried on the ranks: the first is the one-step run's bit
    for bit, the second JAX's step taken from the port's own state after
    the first (its params, moments and count)."""
    ref = reference[name]
    res = [r[name] for r in _ranks(reference, model)]
    for r in res:
        got, one = r["carried"][sp], r["steps"][sp][0]
        assert got["step"] == 2 and got["step_plain"]
        assert got["moments_laid_out"]
        assert got["metrics"][0] == one["metrics"][0]
    first = {n: _whole(res, lambda r: r["steps"][sp][0][n])
             for n in ("params", "m", "v")}
    state, met = ref["jstep"](_jax_state(ref, first, 1), ref["jbatch"])
    got = res[0]["carried"][sp]["metrics"][1]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], float(met[k]), rtol=1e-4)
    for n in ("m", "v"):
        want = _port_paths(getattr(state["opt"], n))
        got = _whole(res, lambda r: r["carried"][sp][n])
        errs = {p: _err(got[p], want[p]) for p in got}
        assert max(errs.values()) <= 1e-4, (n, errs)
