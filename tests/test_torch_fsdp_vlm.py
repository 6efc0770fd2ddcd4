"""The vlm family (llama-3.2-vision-11b) under a data axis (FSDP) on the
CPU, held against the JAX package's own sharded steps.

The port's step builders on ``(data 2, model 2)`` and ``(data 2, model 1)``
gloo meshes of ``run_on_local_mesh`` (the rank body is
``tests/torch_spmd_ranks.py``'s ``fsdp_rank``, as in
``tests/test_torch_fsdp.py``): the prompt, the image embeddings and the
train batches split over ``data`` by ``distribute_batch``, weights by
``param_shardings_serving`` or ``param_shardings``, the ``{"self",
"cross"}`` cache by ``cache_shardings`` -- the JAX layout, whose ``data``
entry falls on the self cache's per-group dim (``shape[1]``), not on B.
Held against the JAX package's jitted ``make_prefill_step``,
``make_decode_step``, ``loss_fn`` gradients and ``make_train_step`` on
the same meshes of 4 forced host devices, in one subprocess (the state
placed by ``serve_structs``/``train_state_structs``, the batch by
``batch_spec``), on the same numpy weights, prompts and image embeddings
(f32, drawn from the seed: the JAX trainer's zero embeddings would give
the cross layers no gradient).  Three cases of the self cache:

* (a) ``cross_attn_every`` 3, 6 layers: 2 self layers a group, split over
  ``data`` 2, so each self layer is held, for every row, by one data rank
  (its owner), which writes the rows gathered over ``data`` and sends
  each other rank its rows to decode;
* (b) the reduced config (1 self layer a group): ``data`` does not divide
  it, the self cache is whole over ``data`` and every rank writes the
  gathered rows (its replicas bit-equal) and reads its own;
* (c) B 3 on ``data`` 2: the batch, the image cache and the self cache
  stay whole (the every-3 config's self layers still split over
  ``data``: the owner sends every row).

Held, within 2e-4 of max |reference| (f32): the prefill logits (read whole
by ``collect_batch``), three teacher-forced decode steps, every ``self``
and ``cross`` cache leaf reassembled and compared layer by layer, each
local shape the JAX shard shape; the loss (rtol 1e-5) and every gradient
leaf, ``seq_parallel`` on and off, the cross layers' nonzero; two
``make_train_step`` steps, the second from the JAX sharded run's state
after the first, and two carried on the ranks (as
``tests/test_torch_tp_vlm.py`` holds them).  Guards: the self-cache
exchange runs in case (a) alone; no path reaches ``DTensor.redistribute``;
``_unstack`` of the split self cache gives each layer's owner a view of its
stack; a self or image cache (or image rows) laid out otherwise raises;
the train step at ``scan_chunks`` 2 equals its step at 0 bit for bit,
and a (pod 2, model 2) prefill runs.

One JAX subprocess and two spawns (one a mesh), each with a deadline.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as JST
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import AdamWState, adamw_init

from test_torch_ep import _err, _param_err, _whole
from test_torch_fsdp import (KW, _jax_opt, _np_paths, _path_tree,
                             _unsharded_steps)
from torch_spmd_ranks import fsdp_vlm_rank

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b"
B, S, N_DEC = 4, 16, 3
# config name -> reduced() overrides
CONFIGS = {"vlm": {}, "vlm-every3": dict(cross_attn_every=3, n_layers=6)}
# job name -> (config, mesh, batch, what runs)
JOBS = {"vlm@2x2": ("vlm", (2, 2), B, ("serve", "grads", "steps")),
        "vlm-every3@2x2": ("vlm-every3", (2, 2), B,
                           ("serve", "grads", "steps")),
        "vlm-b3@2x2": ("vlm", (2, 2), 3, ("serve", "grads")),
        "vlm-every3-b3@2x2": ("vlm-every3", (2, 2), 3, ("serve",)),
        "vlm@2x1": ("vlm", (2, 1), B, ("serve", "grads")),
        "vlm-every3@2x1": ("vlm-every3", (2, 1), B, ("serve", "grads"))}

JAX_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.launch.steps as JST
    from repro.configs import get_config
    from repro.launch.mesh import _mesh
    from repro.launch.sharding import (act_spec, batch_spec,
                                       cache_shardings, guard_spec)
    from repro.models import LM
    from repro.models.config import ShapeConfig
    from repro.optim import adamw_init

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(k.key) for k in p): np.asarray(v)
                for p, v in flat}

    jobs = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for name, j in jobs.items():
        cfg = get_config(j["arch"]).reduced(**j["overrides"])
        mesh = _mesh(j["mesh"], tuple(j.get("axes", ("data", "model"))))
        jm = LM(cfg)
        b0 = j["batches"][0]
        nb, ns = b0["ids"].shape
        n = j["dec"].shape[1]

        def put(a):
            spec = guard_spec(mesh, P(batch_spec(mesh)[0]), a.shape)
            return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

        def inputs(b):
            return {k: put(v) for k, v in b.items()}

        r = out[name] = {}
        if "serve" in j["runs"]:
            r["serve"] = {}
            x, img = put(b0["ids"]), put(j["img"])
            for layout in ("serving", "fsdp"):
                shape = ShapeConfig("s", ns + n, nb, "decode")
                ps = JST.serve_structs(cfg, shape, mesh,
                                       layout == "serving")["param_shardings"]
                p = jax.device_put(j["params"], ps)
                _, pre = JST.make_prefill_step(cfg, mesh)
                logits = jax.jit(pre)(p, {"ids": x, "img_embeds": img})
                cache = jm.init_cache(nb, ns + n)
                cache = jax.device_put(cache,
                                       cache_shardings(mesh, cfg, cache))
                local = {"/".join(str(k.key) for k in q):
                         tuple(v.sharding.shard_shape(v.shape)) for q, v in
                         jax.tree_util.tree_flatten_with_path(cache)[0]}
                fill = jax.jit(lambda p, x, c, im: jm.prefill(
                    p, x, c, img_embeds=im))
                _, cache = fill(p, x, cache, img)
                _, dec = JST.make_decode_step(cfg, mesh)
                dec = jax.jit(dec)
                decs = []
                for t in range(n):
                    tok = put(j["dec"][:, t:t + 1])
                    lg, cache = dec(p, cache, {"ids": tok, "pos": ns + t})
                    decs.append(np.asarray(lg))
                r["serve"][layout] = {"logits": np.asarray(logits),
                                      "decode": decs, "cache": paths(cache),
                                      "cache_local": local}
        _, sh = JST.train_state_structs(cfg, mesh)
        p = jax.device_put(j["params"], sh["params"])
        if "grads" in j["runs"]:
            pcon = JST._layer_param_constraint(mesh)
            sp = NamedSharding(mesh, act_spec(mesh))

            def loss(q, b):
                h, _ = jm.apply(
                    q, b["ids"], img_embeds=b["img_embeds"], remat=True,
                    param_constraint=pcon,
                    act_constraint=lambda h: jax.lax.with_sharding_constraint(
                        h, sp))
                return jm.loss(q, h, b["labels"], b["mask"],
                               chunk=j["kw"]["loss_chunk"])

            v, g = jax.jit(jax.value_and_grad(loss))(p, inputs(b0))
            r["grads"] = (float(v), paths(g))
        if "steps" in j["runs"]:
            _, step = JST.make_train_step(cfg, mesh, seq_parallel=True,
                                          **j["kw"])
            step = jax.jit(step)
            state = {"params": p, "opt": jax.device_put(
                adamw_init(j["params"]), sh["opt"])}
            mets = []
            for i, b in enumerate(j["batches"]):
                state, met = step(state, inputs(b))
                mets.append({k: float(v) for k, v in met.items()})
                if i == 0:
                    r["params1"] = jax.tree.map(np.asarray, state["params"])
                    r["opt1"] = (int(state["opt"].step),
                                 jax.tree.map(np.asarray, state["opt"].m),
                                 jax.tree.map(np.asarray, state["opt"].v))
            r["steps"] = {"metrics": mets, "params": paths(state["params"]),
                          "m": paths(state["opt"].m),
                          "v": paths(state["opt"].v)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _draws(rng, cfg, nb: int) -> dict:
    """Two train batches of ``nb`` rows (each with image embeddings of its
    own), the served image embeddings and the teacher-forced decode
    tokens."""
    def img():
        return rng.standard_normal((nb, cfg.n_img_tokens, cfg.d_model)
                                   ).astype(np.float32)

    batches = [{"ids": rng.integers(0, cfg.vocab, (nb, S)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (nb, S)
                                       ).astype(np.int32),
                "mask": (rng.random((nb, S)) < 0.8).astype(np.float32),
                "img_embeds": img()} for _ in range(2)]
    return {"batches": batches, "img": img(),
            "dec": rng.integers(0, cfg.vocab, (nb, N_DEC)).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's sharded runs (a subprocess on 4 forced host
    devices) and the port's ranks on the (2, 2) and (2, 1) meshes."""
    tmp = tmp_path_factory.mktemp("fsdp_vlm")
    rng = np.random.default_rng(43)
    params, jcfgs, cfgs = {}, {}, {}
    for seed, (name, over) in enumerate(CONFIGS.items()):
        jcfgs[name] = jget_config(ARCH).reduced(**over)
        cfgs[name] = get_config(ARCH).reduced(**over)
        jp = jax.jit(JLM(jcfgs[name]).init)(jax.random.PRNGKey(seed))
        params[name] = (jp, jax.tree.map(np.asarray, jp))
    drawn: dict = {}              # one draw a config and batch: both meshes'
    for conf, _, nb, _ in JOBS.values():
        if (conf, nb) not in drawn:
            drawn[conf, nb] = _draws(rng, cfgs[conf], nb)
    draws = {name: drawn[conf, nb] for name, (conf, _, nb, _) in JOBS.items()}
    jobs = {name: {"arch": ARCH, "overrides": CONFIGS[conf], "mesh": mesh,
                   "params": params[conf][1], "runs": runs, "kw": KW,
                   **draws[name]}
            for name, (conf, mesh, _, runs) in JOBS.items()}
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(jobs, f)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _, err = jax_run.communicate(timeout=900)
        assert jax_run.returncode == 0, err[-3000:]
        with open(tmp / "out.pkl", "rb") as f:
            ref = pickle.load(f)
        control, restart = {}, {}
        for name, (conf, _, _, what) in JOBS.items():
            if "steps" not in what:
                continue
            step1, m1, v1 = ref[name]["opt1"]
            p1 = ref[name]["params1"]
            control[name] = _unsharded_steps(
                jcfgs[conf], jax.tree.map(jnp.asarray, p1),
                draws[name]["batches"][1:], _jax_opt(step1, m1, v1))
            restart[name] = (
                params_from_numpy(p1, cfgs[conf].dtype, device="cpu"),
                AdamWState(step=torch.tensor(step1, dtype=torch.int32),
                           m=params_from_numpy(m1, cfgs[conf].dtype,
                                               device="cpu"),
                           v=params_from_numpy(v1, cfgs[conf].dtype,
                                               device="cpu")))

        def port_job(name):
            conf, _, _, what = JOBS[name]
            d = draws[name]
            return {"cfg": cfgs[conf], "kw": KW,
                    "params": params_from_numpy(params[conf][1],
                                                cfgs[conf].dtype,
                                                device="cpu"),
                    "batches": [{k: torch.from_numpy(v) for k, v in
                                 b.items()} for b in d["batches"]],
                    "dec": torch.from_numpy(d["dec"]),
                    "img": torch.from_numpy(d["img"]), "pins": None,
                    "serve": "serve" in what,
                    "grads": {"total": None} if "grads" in what else None,
                    "steps": "steps" in what, "restart": restart.get(name)}

        every3 = draws["vlm-every3@2x2"]
        layouts = (cfgs["vlm-every3"], port_job("vlm-every3@2x2")["params"],
                   torch.from_numpy(every3["batches"][0]["ids"]),
                   torch.from_numpy(every3["img"]))
        port = {}
        for mesh in ((2, 2), (2, 1)):
            names = [n for n, j in JOBS.items() if j[1] == mesh]
            port[mesh] = TMESH.run_on_local_mesh(
                mesh, ("data", "model"), fsdp_vlm_rank,
                {n: port_job(n) for n in names},
                layouts if mesh == (2, 2) else None, device="cpu",
                timeout=480)
    finally:
        jax_run.kill()
    return {"ref": ref, "port": port, "cfgs": cfgs, "jcfgs": jcfgs,
            "draws": draws, "params": {c: p[1] for c, p in params.items()},
            "control": control, "jsteps": {}}


def _ranks(runs, name) -> list:
    return [r[name] for r in runs["port"][JOBS[name][1]]]


def _layout(name):
    return TMESH.MeshLayout(JOBS[name][1], ("data", "model"))


def _by_layer(path: str, got, want) -> dict:
    """Each layer's error of a cache leaf: ``self`` ``[G, per, ...]`` by
    (g, j), ``cross`` ``[G, ...]`` by g."""
    if path.startswith("self/"):
        return {(g, j): _err(got[g, j], want[g, j])
                for g in range(got.shape[0]) for j in range(got.shape[1])}
    return {(g,): _err(got[g], want[g]) for g in range(got.shape[0])}


SERVE = [(n, lay) for n, j in JOBS.items() if "serve" in j[3]
         for lay in ("serving", "fsdp")]


@pytest.mark.parametrize("name,layout", SERVE,
                         ids=[f"{n}-{lay}" for n, lay in SERVE])
def test_fsdp_vlm_serving_matches_jax_sharded(runs, name, layout):
    """The prefill logits, the decode logits, each layer of every cache
    leaf, and each local shape against the JAX shard shape; ranks holding
    the same part of a leaf hold the same bits."""
    ref = runs["ref"][name]["serve"][layout]
    res = _ranks(runs, name)
    conf, _, nb, _ = JOBS[name]
    cfg = runs["cfgs"][conf]
    split = nb % 2 == 0
    got = [r["serve"][layout] for r in res]
    logits = _whole(got, lambda g: {"x": g["logits"]})["x"]
    assert _err(logits, ref["logits"]) <= 2e-4
    for g in got:
        assert g["laid_out"]
        assert torch.equal(g["collected"], logits)
        assert g["input_local"][0] == (nb // 2 if split else nb)
    for j in range(N_DEC):
        dec = _whole(got, lambda g: {"x": g["decode"][j]})["x"]
        assert _err(dec, ref["decode"][j]) <= 2e-4
    cache = _whole(got, lambda g: g["cache"])
    assert set(cache) == set(ref["cache"]) == {"self/k", "self/v",
                                               "cross/ck", "cross/cv"}
    for path in cache:
        errs = _by_layer(path, cache[path],
                         torch.as_tensor(ref["cache"][path]))
        assert max(errs.values()) <= 2e-4, (path, errs)
    layout_ = _layout(name)
    whole = TST.abstract_cache(cfg, nb, S + N_DEC)
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.cache_shardings(layout_, cfg, whole))
    for g in got:
        for path, (local, _, shape) in g["cache"].items():
            assert tuple(local.shape) == TS.local_shape(
                layout_, specs[path], shape) == ref["cache_local"][path], path
        # the image K/V: the batch's rows; the self cache: every row
        assert g["cache"]["cross/ck"][0].shape[1] == (nb // 2 if split
                                                      else nb)
        assert g["cache"]["self/k"][0].shape[2] == nb
    for path in cache:                  # the replicas of a part agree
        for a in got:
            for b in got:
                if a["cache"][path][1] == b["cache"][path][1]:
                    assert torch.equal(a["cache"][path][0],
                                       b["cache"][path][0]), path


GRADS = [(n, sp) for n, j in JOBS.items() if "grads" in j[3]
         for sp in (True, False)]


@pytest.mark.parametrize("name,sp", GRADS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in GRADS])
def test_fsdp_vlm_loss_and_gradients_match_jax_sharded(runs, name, sp):
    want_loss, want = runs["ref"][name]["grads"]
    res = _ranks(runs, name)
    for r in res:
        loss, _, laid_out, _ = r["grads"][sp]["total"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert laid_out
    got = _whole(res, lambda r: r["grads"][sp]["total"][1])
    assert set(got) == set(want)
    errs = {p: _err(got[p], want[p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs
    for n in ("wq", "wk", "wv", "wo"):              # the cross layers'
        assert float(got[f"cross/attn/{n}"].abs().max()) > 0


STEPS = [(n, sp) for n, j in JOBS.items() if "steps" in j[3]
         for sp in (True, False)]


@pytest.mark.parametrize("name,sp", STEPS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in STEPS])
def test_fsdp_vlm_steps_from_jax_first_step_match_jax_sharded(runs, name,
                                                              sp):
    """Two ``make_train_step`` steps, the second from the JAX sharded
    run's state after the first, each held to JAX's: the metrics (rtol
    1e-4, grad_norm one number on every rank), the moments within 1e-4 at
    their ``opt_shardings`` local shapes; the params after step 1 where
    AdamW's sign is fixed within 1e-4, and after step 2 within 1e-4 or
    twice the distance of the JAX package's own unsharded step from the
    same state."""
    ref = runs["ref"][name]
    res = _ranks(runs, name)
    layout = _layout(name)
    whole = TST.abstract_params(runs["cfgs"][JOBS[name][0]])
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.opt_shardings(layout, adamw_init(whole), whole).m)
    for i in range(2):
        for r in res:
            st = r["steps"][sp][i]
            assert st["step"] == i + 1 and st["step_plain"]
            assert st["moments_laid_out"]
            (got,) = st["metrics"]
            want = ref["steps"]["metrics"][i]
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6)
            for nm in ("m", "v"):
                for path, (local, _, shape) in st[nm].items():
                    assert tuple(local.shape) == TS.local_shape(
                        layout, specs[path], shape), (nm, path)
        norms = {r["steps"][sp][i]["metrics"][0]["grad_norm"] for r in res}
        assert len(norms) == 1, norms
    g1 = {p: torch.as_tensor(np.asarray(v, np.float32)) for p, v in
          ref["grads"][1].items()}
    _, m1, v1 = ref["opt1"]
    want1 = {"params": _np_paths(ref["params1"]), "m": _np_paths(m1),
             "v": _np_paths(v1)}
    got = _whole(res, lambda r: r["steps"][sp][0]["params"])
    errs = {p: _param_err(got[p], want1["params"][p], g1[p]) for p in got}
    assert max(errs.values()) <= 1e-4, errs
    got = _whole(res, lambda r: r["steps"][sp][1]["params"])
    unsharded, over = runs["control"][name], {}
    for p in got:
        err = _param_err(got[p], ref["steps"]["params"][p], g1[p])
        control = _param_err(torch.as_tensor(unsharded[p]),
                             ref["steps"]["params"][p], g1[p])
        if err > max(1e-4, 2 * control):
            over[p] = (err, control)
    assert not over, over
    for i, want in enumerate((want1, ref["steps"])):
        for nm in ("m", "v"):
            got = _whole(res, lambda r: r["steps"][sp][i][nm])
            errs = {p: _err(got[p], want[nm][p]) for p in got}
            assert max(errs.values()) <= 1e-4, (i, nm, errs)


@pytest.mark.parametrize("name,sp", STEPS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in STEPS])
def test_fsdp_vlm_carried_second_step_is_jax_step_from_the_first(
        runs, name, sp):
    """Two steps carried on the ranks: the first is the one-step run's bit
    for bit, and the second is JAX's step (unsharded, the same values)
    taken from the port's own state after the first (its params, moments
    and count): the metrics rtol 1e-4, the moments within 1e-4."""
    conf = JOBS[name][0]
    res = _ranks(runs, name)
    for r in res:
        got, one = r["carried"][sp], r["steps"][sp][0]
        assert got["step"] == 2 and got["step_plain"]
        assert got["moments_laid_out"]
        assert got["metrics"][0] == one["metrics"][0]
    first = {n: _whole(res, lambda r: r["steps"][sp][0][n])
             for n in ("params", "m", "v")}
    if conf not in runs["jsteps"]:
        _, jstep = JST.make_train_step(runs["jcfgs"][conf], None,
                                       seq_parallel=False, **KW)
        runs["jsteps"][conf] = jax.jit(jstep)
    like = runs["params"][conf]
    state = {"params": _path_tree(first["params"], like),
             "opt": _jax_opt(1, _path_tree(first["m"], like),
                             _path_tree(first["v"], like))}
    batch = {k: jnp.asarray(v)
             for k, v in runs["draws"][name]["batches"][1].items()}
    state, met = runs["jsteps"][conf](state, batch)
    got = res[0]["carried"][sp]["metrics"][1]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], float(met[k]), rtol=1e-4)
    want = {"m": _np_paths(state["opt"].m), "v": _np_paths(state["opt"].v)}
    for n in ("m", "v"):
        got = _whole(res, lambda r: r["carried"][sp][n])
        errs = {p: _err(got[p], want[n][p]) for p in got}
        assert max(errs.values()) <= 1e-4, (n, errs)


# job -> the self-cache exchanges (held_rows calls) a rank makes in its
# serving runs: every self layer held by one data rank is read twice (k,
# v) a decode step, under both layouts; none where the layers are whole
EXCHANGES = {"vlm@2x2": 0, "vlm-b3@2x2": 0, "vlm@2x1": 0,
             "vlm-every3@2x2": 2 * 4 * 2 * N_DEC,
             "vlm-every3-b3@2x2": 2 * 4 * 2 * N_DEC,
             "vlm-every3@2x1": 2 * 4 * 2 * N_DEC}


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_fsdp_vlm_self_cache_exchange_runs_where_layers_are_held(runs,
                                                                 name):
    """The self layers split over data (case a, and case c's every-3
    config) are read through the owner's exchange, on every rank, at
    every decode step; whole ones (case b) never are."""
    for r in _ranks(runs, name):
        assert r["held_rows_calls"] == EXCHANGES[name]


@pytest.mark.parametrize("name", ["vlm-b3@2x2", "vlm-every3-b3@2x2"])
def test_fsdp_vlm_batch_the_axis_does_not_divide_stays_whole(runs, name):
    """B 3 on data 2: the batch, the image embeddings and the image cache
    stay whole on every rank, every rank computes all 3 rows, and no
    gradient is summed over data (a sum would double every one)."""
    for r in _ranks(runs, name):
        assert all(shape[0] == 3 for shape in r["batch_local"].values())
        for lay in ("serving", "fsdp"):
            cache = r["serve"][lay]["cache"]
            assert r["serve"][lay]["input_local"][0] == 3
            assert cache["cross/ck"][0].shape[1] == 3
            assert cache["self/k"][0].shape[2] == 3


def test_fsdp_vlm_unstack_gives_each_owner_its_view(runs):
    """``_unstack`` of the every-3 config's self cache on (2, 2) (per 2
    over data 2): a ``HeldBy`` record a layer on every rank, in the order
    g * per + j, held by data rank j // 1 at local index g; the owner's
    view is its stack's at [g, 0] (a write lands there), the other rank
    holds none."""
    cfg = runs["cfgs"]["vlm-every3"]
    G, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    for r in runs["port"][(2, 2)]:
        got = r["held"]
        assert len(got) == G * per
        for i, (kind, owner, index, ok) in enumerate(got):
            g, j = divmod(i, per)
            assert (kind, owner, index, ok) == ("held", j, g, True), (i, got)


LAYOUTS = ["self split by batch", "self of another batch", "image whole",
           "image embeddings whole"]


@pytest.mark.parametrize("what", LAYOUTS)
def test_fsdp_vlm_cache_laid_out_otherwise_raises(runs, what):
    """On (2, 2), against a prompt split over data: the JAX layout runs; a
    self cache whose B is split, a self cache of another batch, an image
    K/V whole over B, and image rows whole beside the prompt's split rows
    each raise, naming rows."""
    for r in runs["port"][(2, 2)]:
        assert r["layouts"]["jax"] == ""
        assert "rows" in r["layouts"][what], r["layouts"][what]


@pytest.mark.parametrize("what,msg", [("scan_chunks", "scan_chunks=2"),
                                      ("pod", "'pod': 2")])
def test_fsdp_vlm_runs_pod_and_scan_chunks(runs, what, msg):
    """The vlm family under a data axis: its train step at ``scan_chunks``
    2 (``msg``: the option) equals its step at 0 bit for bit, the
    metrics, params and moments (the family checkpoints each group and
    ignores the option, as JAX's ``_apply_vlm`` does); a pod axis of 2
    (``msg``: the axis) is a batch axis: its prefill step on a (pod 2,
    model 2) mesh of the same ranks, the prompt and the image rows split
    over pod, equals the whole run's logits within 2e-4 of their max
    (``tests/test_torch_pod.py`` holds the pod axis to JAX)."""
    for r in runs["port"][(2, 2)]:
        got = r["layouts"]["others"][what]
        if what == "pod":
            logits, whole = got
            assert logits.shape == whole.shape
            assert _err(logits, whole.numpy()) <= 2e-4, msg
        else:
            equal, loss = got
            assert equal and np.isfinite(loss), msg


def test_fsdp_vlm_global_norm_counts_each_leaf_once(runs):
    """``global_norm`` of each config's params tree by ``param_shardings``
    equals the whole tree's on every rank of both meshes."""
    for mesh in ((2, 2), (2, 1)):
        for r in runs["port"][mesh]:
            for name, j in JOBS.items():
                if j[1] == mesh:
                    got, want, n = r[name]["norm"]
                    assert n >= 10
                    np.testing.assert_allclose(got, want, rtol=1e-6)
