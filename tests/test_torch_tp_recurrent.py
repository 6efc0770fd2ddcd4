"""The hybrid (hymba) and ssm (rwkv) families under a model axis on the
CPU, held against the JAX package.

The port's serve steps (weights by ``param_shardings_serving``, a cache by
``cache_shardings``) and train step (params by ``param_shardings``,
moments by ``opt_shardings``) on ``(1, model)`` gloo meshes of
``run_on_local_mesh``, against the JAX package's unsharded
``make_prefill_step`` / ``make_decode_step``, ``loss_fn`` under
``jax.value_and_grad`` and ``make_train_step(cfg, None)`` on the same
numpy-seeded f32 weights (GSPMD changes no value), with every leaf the
reference sets to zeros or ones (``mu``, ``mu_c``, ``w_bias``, ``u``,
``ln_scale``, ``dt_bias``, ``A_log``, ``D``) drawn from the seed:

* hymba reduced on 2 ranks (2 of 4 heads, 1 of 2 kv heads and half the
  inner channels a rank) and on 4 (1 head a rank; the 2 kv heads stay
  whole and the k/v cache splits its head_dim);
* hymba reduced to 3 heads over 1 kv head on 2 ranks: the heads stay whole
  while ``attn/wo``'s rows split (head 1 cut in two);
* rwkv reduced to d 256 (4 heads of 64) on 2 and 4 ranks: each rank's
  columns are whole heads;
* rwkv reduced to d 192 (3 heads) on 2 ranks: each rank's 96 columns cut
  head 1, so r, k, v and w are gathered and every rank runs the whole
  scan;
* the prefill step's logits, 3 teacher-forced decode steps' logits and
  every cache leaf (hymba's k/v and ssm ``h``/``conv``; rwkv's ``S``,
  ``tm_last``, ``cm_last``) reassembled from the ranks' shards, within
  2e-4 of max |reference|; the state's local shapes are its
  ``cache_shardings`` spec's (rwkv's ``S`` split on its last dim);
* with ``seq_parallel`` on and off: the loss (rtol 1e-5) and every
  gradient leaf reassembled from the ranks' shards within 2e-4 of max
  |reference|, every leaf held whole equal on every rank; two
  ``make_train_step`` steps, each held to JAX's as
  ``tests/test_torch_tp_train.py`` holds them: the metrics (rtol 1e-4)
  and the moments (1e-4 of max |reference|), every replica of a whole
  leaf equal on every rank; after the first step also the params where
  the gradient fixes the sign of AdamW's first update (its rule; after
  the second, the zero-initialised norm scales hold values of ~lr, and
  an element whose first moment is small moves by ~2e-4 of lr with the
  f32 noise of its gradient, over 1e-4 of the leaf's largest value, with
  or without a model axis).  The second step starts
  from JAX's state after the first (its params, moments and count), not
  from the port's own: at rwkv's d 256 and 192 the tied logits reach
  hundreds (losses of ~150), and the f32 noise of the first gradient,
  amplified by AdamW's first update g / (|g| + eps) where g cancels,
  moves even the one-process port's second-step moments 1.6e-4 to
  2.3e-4 and params up to 6e-4 of max |reference| off JAX's, with no
  model axis at all;
* two steps carried on the ranks, the second held to JAX's step taken
  from the port's own state after the first, as the second step above:
  what the port carries from one step to the next is checked, and the
  carried moments' distance to JAX's own carried step, recorded beside
  it, witnesses the noise above.

Two spawns (one a mesh), each with a deadline.
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

from test_torch_tp_train import _err, _param_err, _paths, _port_paths, _whole
from torch_spmd_ranks import tp_recurrent_rank

torch.set_num_threads(1)

B, S, N, CHUNK = 2, 16, 3, 8
KW = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=CHUNK)
# name -> (arch, reduced() overrides, the meshes' model axes)
CONFIGS = {"hymba": ("hymba-1.5b", {}, (2, 4)),
           "hymba-whole-heads": ("hymba-1.5b",
                                 dict(n_heads=3, n_kv_heads=1), (2,)),
           "rwkv": ("rwkv6-1.6b", dict(d_model=256), (2, 4)),
           "rwkv-cut-head": ("rwkv6-1.6b", dict(d_model=192), (2,))}
# the leaves ``ssm_init`` and ``rwkv_init`` set to zeros or ones, drawn
# instead: name -> (low, high) of a uniform draw
STATE_LEAF_DRAWS = {"dt_bias": (-2.0, 0.0), "A_log": (-1.0, 1.0),
                    "D": (0.5, 1.5), "mu": (0.0, 1.0), "mu_c": (0.0, 1.0),
                    "w_bias": (-3.0, 0.0), "u": (-0.5, 0.5),
                    "ln_scale": (0.5, 1.5)}
CASES = [(n, m) for n, (_, _, ms) in CONFIGS.items() for m in ms]
IDS = [f"{n}-model{m}" for n, m in CASES]
SP_CASES = [(n, m, sp) for n, m in CASES for sp in (True, False)]
SP_IDS = [f"{n}-model{m}-{'seq' if sp else 'noseq'}"
          for n, m, sp in SP_CASES]


def _jax_reference(name: str, seed: int) -> dict:
    """One config's JAX runs: serving (prefill logits, N decode steps'
    logits, the cache after them), the loss and gradients on one batch,
    and two train steps."""
    arch, over, _ = CONFIGS[name]
    jc, cfg = (jget_config(arch).reduced(**over),
               get_config(arch).reduced(**over))
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    blk = "rwkv" if jc.rwkv else "ssm"
    jp["layers"][blk] = {
        k: (jnp.asarray(rng.uniform(*STATE_LEAF_DRAWS[k], v.shape), v.dtype)
            if k in STATE_LEAF_DRAWS else v)
        for k, v in jp["layers"][blk].items()}
    ids = rng.integers(0, jc.vocab, (B, S))
    steps = rng.integers(0, jc.vocab, (B, N))
    draws = [(rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              (rng.random((B, S)) < 0.8).astype(np.float32))
             for _ in range(2)]

    _, jpre = JST.make_prefill_step(jc)
    logits = np.asarray(jpre(jp, {"ids": jnp.asarray(ids)}))
    jcache = jm.init_cache(B, S + N)
    _, jcache = jm.prefill(jp, jnp.asarray(ids), jcache)
    _, jdec = JST.make_decode_step(jc)
    jdec = jax.jit(jdec)
    dec = []
    for j in range(N):
        lg, jcache = jdec(jp, jcache, {"ids": jnp.asarray(steps[:, j:j + 1]),
                                       "pos": S + j})
        dec.append(np.asarray(lg))

    ids0, labels0, mask0 = draws[0]

    def loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(ids0), remat=True)
        return jm.loss(p, h, jnp.asarray(labels0), jnp.asarray(mask0),
                       chunk=CHUNK)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    _, jstep = JST.make_train_step(jc, None, seq_parallel=False, **KW)
    jstep = jax.jit(jstep)
    state, metrics, after = {"params": jp, "opt": j_adamw_init(jp)}, [], []
    for i, lb, m in draws:
        state, met = jstep(state, {"ids": jnp.asarray(i),
                                   "labels": jnp.asarray(lb),
                                   "mask": jnp.asarray(m)})
        metrics.append({k: float(v) for k, v in met.items()})
        after.append({k: _port_paths(v) for k, v in
                      (("params", state["params"]),
                       ("m", state["opt"].m), ("v", state["opt"].v))})
        if len(after) == 1:
            mid = state

    batches = [{"ids": torch.from_numpy(i).long(),
                "labels": torch.from_numpy(lb), "mask": torch.from_numpy(m)}
               for i, lb, m in draws]

    def port(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree), cfg.dtype,
                                 device="cpu")

    params = port(jp)
    start1 = (port(mid["params"]), AdamWState(
        step=torch.tensor(int(mid["opt"].step), dtype=torch.int32),
        m=port(mid["opt"].m), v=port(mid["opt"].v)))
    job = (cfg, params, torch.from_numpy(ids).long(),
           torch.from_numpy(steps).long(), batches[0], batches, start1)
    return {"cfg": cfg, "params": params, "job": job, "logits": logits,
            "decode": dec, "cache": _port_paths(jcache),
            "loss": float(loss), "grads": _port_paths(grads),
            "metrics": metrics, "after": after, "jstep": jstep,
            "jbatch": {"ids": jnp.asarray(draws[1][0]),
                       "labels": jnp.asarray(draws[1][1]),
                       "mask": jnp.asarray(draws[1][2])},
            "jstate": mid}


@pytest.fixture(scope="module")
def reference():
    return {name: _jax_reference(name, seed)
            for seed, name in enumerate(CONFIGS)}


_RUNS: dict = {}


def _ranks(ref, model: int) -> list:
    """Every rank's results on a (1, model) mesh, for the configs run on
    it (one spawn a mesh)."""
    if model not in _RUNS:
        jobs = {n: ref[n]["job"] for n, (_, _, ms) in CONFIGS.items()
                if model in ms}
        _RUNS[model] = TMESH.run_on_local_mesh(
            (1, model), ("data", "model"), tp_recurrent_rank, jobs, KW,
            device="cpu", timeout=600)
    return _RUNS[model]


@pytest.mark.parametrize("name,model", CASES, ids=IDS)
def test_tp_recurrent_serving_matches_jax_unsharded(reference, name, model):
    ref = reference[name]
    res = [r[name]["serve"] for r in _ranks(reference, model)]
    layout = TMESH.MeshLayout((1, model), ("data", "model"))
    for r in res:
        assert r["all_dtensors"]
        assert _err(r["logits"], ref["logits"]) <= 2e-4
        assert len(r["decode"]) == N
        for got, want in zip(r["decode"], ref["decode"]):
            assert _err(got, want) <= 2e-4
    cache = _whole(res, lambda r: r["cache"])
    assert set(cache) == set(ref["cache"])
    errs = {p: _err(cache[p], ref["cache"][p]) for p in cache}
    assert max(errs.values()) <= 2e-4, errs
    # each rank holds its cache_shardings shard of the state
    cfg = ref["cfg"]
    whole = TST.abstract_cache(cfg, B, S + N)
    specs = _paths(TS.cache_shardings(layout, cfg, whole))
    for r in res:
        for path, (local, _, shape) in r["cache"].items():
            assert tuple(local.shape) == TS.local_shape(
                layout, specs[path].spec, shape), path
    if cfg.rwkv:        # S [L, B, H, hd, hd]: its last dim over the ranks
        assert tuple(specs["S"].spec)[2:] == (None, None, "model")
        local = res[0]["cache"]["S"][0]
        assert local.shape[-1] == 64 // model
    else:               # the ssm state: the inner channels over the ranks
        assert res[0]["cache"]["ssm/h"][0].shape[2] == cfg.d_model // model
        assert res[0]["cache"]["ssm/conv"][0].shape[3] == (
            cfg.d_model // model)


@pytest.mark.parametrize("name,model,sp", SP_CASES, ids=SP_IDS)
def test_tp_recurrent_loss_and_gradients_match_jax(reference, name, model,
                                                   sp):
    ref = reference[name]
    res = [r[name] for r in _ranks(reference, model)]
    for r in res:
        np.testing.assert_allclose(r["loss"][sp], ref["loss"], rtol=1e-5)
        assert r["laid_out"][sp]
    got = _whole(res, lambda r: r["grads"][sp])     # replicas equal
    assert set(got) == set(ref["grads"])
    errs = {p: _err(got[p], ref["grads"][p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs


@pytest.mark.parametrize("name,model,sp", SP_CASES, ids=SP_IDS)
def test_tp_recurrent_two_train_steps_match_jax(reference, name, model, sp):
    """Step 1 from the shared start, step 2 from JAX's state after step 1
    (the module docstring), each held to JAX's step."""
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


def _jax_state(ref, first: dict, step: int):
    """JAX's train state holding ``first`` (name → path → whole leaf: the
    port's params, m and v) at optimizer step ``step``."""
    def tree(paths):
        return TS.map_with_path(lambda p, _: jnp.asarray(
            paths[TS.path_str(p)].numpy()), ref["params"])

    opt = ref["jstate"]["opt"]
    return {"params": tree(first["params"]), "opt": type(opt)(
        step=jnp.asarray(step, opt.step.dtype), m=tree(first["m"]),
        v=tree(first["v"]))}


@pytest.mark.parametrize("name,model,sp", SP_CASES, ids=SP_IDS)
def test_tp_recurrent_carried_second_step_is_jax_step_from_the_first(
        reference, name, model, sp, record_property):
    """Two steps carried on the ranks: the first is the one-step run's bit
    for bit, and the second is JAX's step taken from the port's own state
    after the first (its params, moments and count), the metrics and the
    moments held as in :func:`test_tp_recurrent_two_train_steps_match_jax`.
    So nothing the port carries from one step to the next is lost or
    changed, while JAX's own second step, from its own first, may differ
    by the first step's f32 noise (the module docstring): both distances
    are recorded as the test's properties (``--junitxml``)."""
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
    want = {"m": _port_paths(state["opt"].m), "v": _port_paths(state["opt"].v)}
    for n in ("m", "v"):
        got = _whole(res, lambda r: r["carried"][sp][n])
        errs = {p: _err(got[p], want[n][p]) for p in got}
        record_property(f"{n}_off_jax_from_the_first", max(errs.values()))
        record_property(f"{n}_off_jax_carried", max(
            _err(got[p], ref["after"][1][n][p]) for p in got))
        assert max(errs.values()) <= 1e-4, (n, errs)
