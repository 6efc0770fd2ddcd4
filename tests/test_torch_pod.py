"""``pod`` as a second batch axis on the CPU, held against the JAX
package's own sharded steps.

The port's step builders on ``(pod 2, data 2, model 1)`` and ``(pod 2,
data 1, model 2)`` gloo meshes of ``run_on_local_mesh`` (the rank body is
``tests/torch_spmd_ranks.py``'s ``pod_rank``, over ``fsdp_rank`` and
``fsdp_vlm_rank``): the batch split over ``("pod", "data")`` by
``distribute_batch``, pod-major, weights by ``param_shardings_serving`` or
``param_shardings`` (replicated over ``pod``, a storage-only dim split
over ``data``), against the JAX package's jitted ``make_prefill_step``,
``make_decode_step``, ``loss_fn`` gradients and ``make_train_step`` on
``jax.make_mesh`` meshes of the same shape and axes on 4 forced host
devices (``tests/test_torch_fsdp.py``'s and ``tests/test_torch_fsdp_vlm.py``'s
JAX scripts, three subprocesses), on the same numpy weights and inputs.
The reduced f32 configs of those files: gemma3, musicgen-large's audio
path, moonshot (routing pinned from JAX, its groups those of 4 batch
shards, or 2), hymba and rwkv at d 256 (their zero- and one-initialised
leaves drawn), and llama-3.2-vision-11b with ``cross_attn_every`` 5 (one
group of 4 self layers: on (2, 2, 1) each batch rank holds one, its
``per`` dim split over ``("pod", "data")``; on (2, 1, 2) each pod rank
two); B 4 x S 16, loss chunk 8:

* serving under both layouts: the prefill logits (read whole by
  ``collect_batch``), three teacher-forced decode steps and every cache
  leaf (the vlm caches layer by layer) within 2e-4 of max |reference|,
  each cache leaf's local shape ``local_shape`` of its ``cache_spec`` and
  the JAX cache's shard shape;
* the train loss (rtol 1e-5) and every gradient leaf, reassembled, within
  2e-4 of max |reference|, ``seq_parallel`` on and off; two
  ``make_train_step`` steps (the tolerances of ``tests/test_torch_fsdp.py``:
  metrics rtol 1e-4, grad_norm one number on every rank, params and
  moments within 1e-4 or twice the JAX package's own unsharded-vs-sharded
  distance, the moments at their ``opt_shardings`` local shapes);
  moonshot's, rwkv's and the vlm's second step from the JAX sharded run's
  state after the first, as those files hold rwkv and the vlm, the first
  step then held by the JAX package's own unsharded first step;
* the moe aux losses (rtol 1e-5) and ``dropped_frac`` equal on every
  rank, and ``moe_apply`` at G 1, 2 and 4 with drops on a batch split over
  the 4 batch ranks (a group spanning 4 or 2 ranks' rows, the positions
  counted on pod-major);
* the vlm self cache's holder is per layer (``_unstack``'s ``HeldBy``
  records: layer j's owner the rank at pod-major position j, or j // 2 on
  (2, 1, 2)), its exchange runs, and a planted ``owner + 1`` fails the
  cache comparison;
* B 2 on a batch of 4 ranks stays whole (batch, cache, no gradient sum);
* ``global_norm`` of each config's tree by ``param_shardings`` counts each
  leaf once (a leaf replicated over ``pod`` among them).

Three JAX subprocesses and two spawns (one a mesh), each with a deadline.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import AdamWState, adamw_init

import test_torch_fsdp as F
import test_torch_fsdp_vlm as FV
from test_torch_ep import _err, _param_err, _whole
from torch_spmd_ranks import pod_rank

torch.set_num_threads(1)

AXES = ("pod", "data", "model")
B, S, N_DEC, KW = F.B, F.S, F.N_DEC, F.KW
CONFIGS = {**{c: F.ARCHS[c] for c in ("dense", "moe", "audio", "hybrid",
                                      "ssm")},
           "vlm": (FV.ARCH, dict(cross_attn_every=5, n_layers=5))}
# job name -> (config, mesh, batch, what runs)
JOBS = {"dense@2x2x1": ("dense", (2, 2, 1), B, ("serve", "grads", "steps")),
        "audio@2x2x1": ("audio", (2, 2, 1), B, ("serve", "grads", "steps")),
        "moe@2x2x1": ("moe", (2, 2, 1), B, ("serve", "grads", "steps")),
        "hybrid@2x2x1": ("hybrid", (2, 2, 1), B, ("serve", "grads",
                                                   "steps")),
        "ssm@2x2x1": ("ssm", (2, 2, 1), B, ("serve", "grads", "steps")),
        "vlm@2x2x1": ("vlm", (2, 2, 1), B, ("serve", "grads", "steps")),
        "b2@2x2x1": ("dense", (2, 2, 1), 2, ("serve", "grads")),
        "dense@2x1x2": ("dense", (2, 1, 2), B, ("serve", "grads", "steps")),
        "audio@2x1x2": ("audio", (2, 1, 2), B, ("serve", "grads")),
        "moe@2x1x2": ("moe", (2, 1, 2), B, ("serve", "grads")),
        "hybrid@2x1x2": ("hybrid", (2, 1, 2), B, ("serve", "grads")),
        "ssm@2x1x2": ("ssm", (2, 1, 2), B, ("serve", "grads")),
        "vlm@2x1x2": ("vlm", (2, 1, 2), B, ("serve", "grads"))}
# the configs whose second step starts from the JAX run's state after
# the first (test_torch_fsdp.py's and test_torch_fsdp_vlm.py's reasons;
# moonshot's zero-initialised ln2 scale carries the f32 order of a pod x
# data sum of its first gradient through AdamW to 2.9x the JAX package's
# own unsharded-vs-sharded distance after a carried second step)
RESTARTED = ("moe", "ssm", "vlm")
PLANT = "vlm@2x2x1"


def _shards(mesh) -> int:
    """Batch shards of a (pod, data, model) mesh: JAX's moe groups."""
    return mesh[0] * mesh[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's sharded runs (three subprocesses on 4 forced host
    devices; the moe routing recorded from its unsharded functions with
    the groups of each mesh's batch shards) and the port's ranks on the
    (2, 2, 1) and (2, 1, 2) meshes."""
    tmp = tmp_path_factory.mktemp("pod")
    rng = np.random.default_rng(59)
    params, jcfgs, cfgs = {}, {}, {}
    for conf, (arch, over) in CONFIGS.items():
        jcfgs[conf] = jget_config(arch).reduced(**over)
        cfgs[conf] = get_config(arch).reduced(**over)
        jp = jax.jit(JLM(jcfgs[conf]).init)(jax.random.PRNGKey(1))
        if jcfgs[conf].rwkv or jcfgs[conf].hybrid:
            jp = F._draw_state_leaves(jp, rng)
        params[conf] = (jp, jax.tree.map(np.asarray, jp))
    drawn: dict = {}
    for conf, _, nb, _ in JOBS.values():
        if (conf, nb) not in drawn:
            if conf == "vlm":
                drawn[conf, nb] = FV._draws(rng, cfgs[conf], nb)
            else:
                batches, dec = F._draws(rng, cfgs[conf], nb)
                drawn[conf, nb] = {"batches": batches, "dec": dec}
    draws = {name: drawn[conf, nb] for name, (conf, _, nb, _) in JOBS.items()}
    jobs = {name: {"arch": CONFIGS[conf][0], "overrides": CONFIGS[conf][1],
                   "mesh": mesh, "axes": AXES, "params": params[conf][1],
                   "runs": runs, "kw": KW, **draws[name],
                   "losses": F.LOSSES if conf == "moe" else
                   {"total": F.LOSSES["total"]}}
            for name, (conf, mesh, _, runs) in JOBS.items()}
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    parts = [(F.JAX_SCRIPT, ("dense", "moe", "audio")),
             (F.JAX_SCRIPT, ("hybrid", "ssm")), (FV.JAX_SCRIPT, ("vlm",))]
    jax_runs = []           # three subprocesses: their jit compiles overlap
    for i, (script, confs) in enumerate(parts):
        with open(tmp / f"in{i}.pkl", "wb") as f:
            pickle.dump({n: j for n, j in jobs.items()
                         if JOBS[n][0] in confs}, f)
        jax_runs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(tmp / f"in{i}.pkl"),
             str(tmp / f"out{i}.pkl")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        gaps: list = []
        moe_ref, moe_job = F._moe_apply_ref(jcfgs["moe"], rng, gaps)
        ref = {}
        for i, run in enumerate(jax_runs):
            _, err = run.communicate(timeout=900)
            assert run.returncode == 0, err[-3000:]
            with open(tmp / f"out{i}.pkl", "rb") as f:
                ref.update(pickle.load(f))
        control, control1, restart = {}, {}, {}
        for name, (conf, mesh, _, what) in JOBS.items():
            if "steps" not in what:
                continue
            batches = draws[name]["batches"]
            if conf not in RESTARTED:
                control[name] = F._unsharded_steps(
                    jcfgs[conf], params[conf][0], batches,
                    shards=_shards(mesh), moments=True)
                continue
            control1[name] = F._unsharded_steps(
                jcfgs[conf], params[conf][0], batches[:1],
                shards=_shards(mesh), moments=True)
            step1, m1, v1 = ref[name]["opt1"]
            p1 = ref[name]["params1"]
            control[name] = F._unsharded_steps(
                jcfgs[conf], jax.tree.map(jnp.asarray, p1), batches[1:],
                F._jax_opt(step1, m1, v1), shards=_shards(mesh),
                moments=True)
            restart[name] = (
                params_from_numpy(p1, cfgs[conf].dtype, device="cpu"),
                AdamWState(step=torch.tensor(step1, dtype=torch.int32),
                           m=params_from_numpy(m1, cfgs[conf].dtype,
                                               device="cpu"),
                           v=params_from_numpy(v1, cfgs[conf].dtype,
                                               device="cpu")))
        pins = {}
        for name, (conf, mesh, _, what) in JOBS.items():
            if conf == "moe":
                d = draws[name]
                p1 = ref[name].get("params1", params[conf][0])
                pins[name] = F._pins(jcfgs[conf], params[conf][0],
                                     d["batches"], d["dec"], p1, gaps,
                                     shards=_shards(mesh))
        assert min(gaps) > F.TIE_GAP, f"a near-tie in the routing: {min(gaps)}"

        def port_job(name):
            conf, _, _, what = JOBS[name]
            d = draws[name]
            job = {"cfg": cfgs[conf], "kw": KW,
                   "params": params_from_numpy(params[conf][1],
                                               cfgs[conf].dtype,
                                               device="cpu"),
                   "batches": [{k: torch.from_numpy(v) for k, v in
                                b.items()} for b in d["batches"]],
                   "dec": torch.from_numpy(d["dec"]),
                   "pins": pins.get(name), "serve": "serve" in what,
                   "grads": ({"total": None,
                              **{k: F.LOSSES[k] for k in ("aux", "gate")}}
                             if conf == "moe" else {"total": None})
                   if "grads" in what else None,
                   "steps": "steps" in what, "restart": restart.get(name)}
            if conf == "vlm":
                job["img"] = torch.from_numpy(d["img"])
            return job

        port = {}
        for mesh in ((2, 2, 1), (2, 1, 2)):
            names = [n for n, j in JOBS.items() if j[1] == mesh]
            big = mesh == (2, 2, 1)
            port[mesh] = TMESH.run_on_local_mesh(
                mesh, AXES, pod_rank, {n: port_job(n) for n in names},
                moe_job if big else None, PLANT if big else None,
                device="cpu", timeout=600)
    finally:
        for run in jax_runs:
            run.kill()
    return {"ref": ref, "port": port, "cfgs": cfgs, "moe_ref": moe_ref,
            "control": control, "control1": control1}


def _ranks(runs, name) -> list:
    return [r[name] for r in runs["port"][JOBS[name][1]]]


def _layout(name):
    return TMESH.MeshLayout(JOBS[name][1], AXES)


def _split(name) -> bool:
    """The batch is split over the pod x data ranks (each holding 1 or 2
    rows); else whole on every rank."""
    _, mesh, nb, _ = JOBS[name]
    return nb % _shards(mesh) == 0


def _cache_specs(name) -> dict:
    conf, _, nb, _ = JOBS[name]
    cfg = get_config(CONFIGS[conf][0]).reduced(**CONFIGS[conf][1])
    whole = TST.abstract_cache(cfg, nb, S + N_DEC)
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.cache_shardings(_layout(name), cfg, whole))
    return specs


SERVE = [(n, lay) for n, j in JOBS.items() if "serve" in j[3]
         for lay in ("serving", "fsdp")]


@pytest.mark.parametrize("name,layout", SERVE,
                         ids=[f"{n}-{lay}" for n, lay in SERVE])
def test_pod_serving_matches_jax_sharded(runs, name, layout):
    """The prefill logits (a DTensor of the rank's rows, read whole by
    ``collect_batch``), the decode logits, every cache leaf (the vlm's
    layer by layer), each local shape against the JAX shard shape, and the
    rows each rank holds of the prompt."""
    ref = runs["ref"][name]["serve"][layout]
    res = _ranks(runs, name)
    conf, mesh, nb, _ = JOBS[name]
    rows = nb // _shards(mesh) if _split(name) else nb
    got = [r["serve"][layout] for r in res]
    logits = _whole(got, lambda g: {"x": g["logits"]})["x"]
    assert _err(logits, ref["logits"]) <= 2e-4
    for g in got:
        assert g["laid_out"]
        assert torch.equal(g["collected"], logits)
        assert g["input_local"][0] == rows
    for j in range(N_DEC):
        dec = _whole(got, lambda g: {"x": g["decode"][j]})["x"]
        assert _err(dec, ref["decode"][j]) <= 2e-4
    cache = _whole(got, lambda g: g["cache"])
    assert set(cache) == set(ref["cache"])
    for path in cache:
        want = torch.as_tensor(ref["cache"][path])
        errs = (FV._by_layer(path, cache[path], want) if conf == "vlm"
                else {(): _err(cache[path], want)})
        assert max(errs.values()) <= 2e-4, (path, errs)
    specs, layout_ = _cache_specs(name), _layout(name)
    for g in got:
        for path, (local, _, shape) in g["cache"].items():
            assert tuple(local.shape) == TS.local_shape(
                layout_, specs[path], shape) == ref["cache_local"][path], path
            if conf == "vlm" and path.startswith("self/"):
                assert local.shape[2] == nb, path     # every row
            else:
                assert local.shape[1] == rows, path


def _grads_ref(runs, name) -> tuple:
    """(loss, path -> gradient) of the JAX run: the dense script keeps
    them by loss part, the vlm script the total alone."""
    g = runs["ref"][name]["grads"]
    return g["total"] if isinstance(g, dict) else g


GRADS = [(n, sp) for n, j in JOBS.items() if "grads" in j[3]
         for sp in (True, False)]


@pytest.mark.parametrize("name,sp", GRADS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in GRADS])
def test_pod_loss_and_gradients_match_jax_sharded(runs, name, sp):
    """The loss (rtol 1e-5; the global batch's mean on every rank) and
    every gradient leaf reassembled, within 2e-4 of max |reference|: a
    leaf whole over ``data`` summed over the pod x data line, one split
    over ``data`` over ``pod`` after its gather's ``data`` sum."""
    want_loss, want = _grads_ref(runs, name)
    res = _ranks(runs, name)
    for r in res:
        loss, _, laid_out, _ = r["grads"][sp]["total"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert laid_out
    got = _whole(res, lambda r: r["grads"][sp]["total"][1])
    assert set(got) == set(want)
    errs = {p: _err(got[p], want[p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs


def _check_steps(runs, name, steps, want_metrics) -> None:
    """The metrics of every rank's ``steps`` (a list of metric dicts)
    against JAX's (rtol 1e-4), grad_norm one number on every rank."""
    for i, want in enumerate(want_metrics):
        norms = set()
        for r in _ranks(runs, name):
            got = steps(r)[i]
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6)
            norms.add(got["grad_norm"])
        assert len(norms) == 1, norms


def _check_state(runs, name, key, want, g1, ctl) -> None:
    """The params after the steps within 1e-4 (``_param_err``) and the
    moments within 1e-4 (of max |reference|), each leaf also passing
    within twice the JAX package's own distance between its unsharded and
    its sharded steps (the f32 order of sums, which AdamW's first update
    carries into the second gradient: musicgen's moments read up to
    9.7e-5 there), the moments at their ``opt_shardings`` local shapes."""
    res = _ranks(runs, name)
    layout = _layout(name)
    whole = TST.abstract_params(runs["cfgs"][JOBS[name][0]])
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.opt_shardings(layout, adamw_init(whole), whole).m)
    got = _whole(res, lambda r: key(r)["params"])
    over = {}
    for p in got:
        err = _param_err(got[p], want["params"][p], g1[p])
        control = _param_err(torch.as_tensor(ctl["params"][p]),
                             want["params"][p], g1[p])
        if err > max(1e-4, 2 * control):
            over[p] = (err, control)
    assert not over, over
    for nm in ("m", "v"):
        got = _whole(res, lambda r: key(r)[nm])
        for p in got:
            err = _err(got[p], want[nm][p])
            control = _err(ctl[nm][p], want[nm][p])
            if err > max(1e-4, 2 * control):
                over[f"{nm} {p}"] = (err, control)
        for r in res:
            assert key(r)["step_plain"] and key(r)["moments_laid_out"]
            for path, (local, _, shape) in key(r)[nm].items():
                assert tuple(local.shape) == TS.local_shape(
                    layout, specs[path], shape), (nm, path)
    assert not over, over


STEPS = [(n, sp) for n, j in JOBS.items() if "steps" in j[3]
         for sp in (True, False)]


@pytest.mark.parametrize("name,sp", STEPS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in STEPS])
def test_pod_two_train_steps_match_jax_sharded(runs, name, sp):
    """Two ``make_train_step`` steps held to JAX's sharded run: carried on
    the ranks, or (moonshot, rwkv and the vlm) the second from the JAX
    run's state after the first, each step's params and moments held as
    :func:`_check_state` holds them (the first's control: the JAX
    package's own unsharded first step)."""
    ref = runs["ref"][name]
    g1 = {p: torch.as_tensor(np.asarray(v, np.float32))
          for p, v in _grads_ref(runs, name)[1].items()}
    if JOBS[name][0] not in RESTARTED:
        _check_steps(runs, name, lambda r: r["steps"][sp]["metrics"],
                     ref["steps"]["metrics"])
        _check_state(runs, name, lambda r: r["steps"][sp], ref["steps"], g1,
                     runs["control"][name])
        return
    for i in range(2):
        _check_steps(runs, name, lambda r: r["steps"][sp][i]["metrics"],
                     ref["steps"]["metrics"][i:i + 1])
    _, m1, v1 = ref["opt1"]
    want1 = {"params": F._np_paths(ref["params1"]), "m": F._np_paths(m1),
             "v": F._np_paths(v1)}
    _check_state(runs, name, lambda r: r["steps"][sp][0], want1, g1,
                 runs["control1"][name])
    _check_state(runs, name, lambda r: r["steps"][sp][1], ref["steps"], g1,
                 runs["control"][name])


MOE = [("moe@2x2x1", True), ("moe@2x2x1", False), ("moe@2x1x2", True)]


@pytest.mark.parametrize("name,sp", MOE, ids=["2x2x1-seq", "2x2x1-noseq",
                                              "2x1x2-seq"])
def test_pod_moe_aux_and_dropped_frac_match_jax_sharded(runs, name, sp):
    """The moe model on a batch split over pod x data (routing groups of
    each batch rank's rows): the aux losses (the global means, rtol
    1e-5), the gradients of the aux terms alone and of the cross-entropy
    alone against JAX's, and ``dropped_frac`` one number on every rank."""
    res = _ranks(runs, name)
    for part in ("aux", "gate"):
        want_loss, want = runs["ref"][name]["grads"][part]
        for r in res:
            np.testing.assert_allclose(r["grads"][sp][part][0], want_loss,
                                       rtol=1e-5)
        got = _whole(res, lambda r: r["grads"][sp][part][1])
        errs = {p: _err(got[p], want[p]) for p in got}
        assert max(errs.values()) <= 2e-4, (part, errs)
    aux = res[0]["grads"][sp]["total"][3]
    np.testing.assert_allclose(aux["total"],
                               runs["ref"][name]["grads"]["total"][0],
                               rtol=1e-5)
    assert {r["grads"][sp]["total"][3]["dropped_frac"] for r in res} == {
        aux["dropped_frac"]}


@pytest.mark.parametrize("mode,groups", F.MOE_CASES,
                         ids=[f"{m}-G{g}" for m, g in F.MOE_CASES])
def test_pod_moe_apply_on_a_pod_data_split_batch_matches_jax(runs, mode,
                                                             groups):
    """``moe_apply`` on x split over the 4 batch ranks of (2, 2, 1): G 1
    (one group over all 4 ranks' rows) and 2 (two ranks a group), the
    positions counted on pod-major from the ranks before, and G 4 (each
    its own); C of the global group, output and gradients within 2e-4,
    aux rtol 1e-5, ``dropped_frac`` exact, with drops."""
    ref = runs["moe_ref"][f"{mode}{groups}"]
    res = [r["moe_apply"][f"{mode}{groups}"] for r in runs["port"][(2, 2, 1)]]
    for r in res:
        assert r["G"] == groups and r["C"] == ref["C"]
        for k in ("load_balance_loss", "router_z_loss"):
            np.testing.assert_allclose(r["aux"][k], ref["aux"][k],
                                       rtol=1e-5, atol=1e-6)
        assert r["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"] > 0
    assert _err(_whole(res, lambda r: {"y": r["y"]})["y"], ref["y"]) <= 2e-4
    got = _whole(res, lambda r: r["grads"])
    errs = {k: _err(got[k], ref["grads"][k]) for k in got}
    assert max(errs.values()) <= 2e-4, errs


def test_pod_batch_the_axes_do_not_divide_stays_whole(runs):
    """B 2 on the 4 batch ranks of (2, 2, 1): pod alone would divide it,
    pod x data does not, so the batch and the cache stay whole on every
    rank (as ``cache_spec`` keeps the cache's B), every rank computes both
    rows, and no gradient is summed over the line (the serving and the
    gradients above hold it to JAX's)."""
    for r in _ranks(runs, "b2@2x2x1"):
        assert all(shape[0] == 2 for shape in r["batch_local"].values())
        for lay in ("serving", "fsdp"):
            assert r["serve"][lay]["input_local"][0] == 2
            for path, (local, _, shape) in r["serve"][lay]["cache"].items():
                assert local.shape[1] == 2 == shape[1], path


@pytest.mark.parametrize("name", ["vlm@2x2x1", "vlm@2x1x2"])
def test_pod_vlm_self_cache_is_held_per_layer(runs, name):
    """``_unstack`` of the self cache (one group of 4 self layers, ``per``
    over pod x data 4, or pod 2): a ``HeldBy`` record a layer on every
    rank, layer j held by the rank at pod-major position j // (4 / n) at
    local index j % (4 / n), the owner's view its stack's (a write lands
    there), the others holding none; the serving runs exchanged rows."""
    n = _shards(JOBS[name][1])
    for r in _ranks(runs, name):
        got = r["held"]
        assert len(got) == 4
        for j, rec in enumerate(got):
            assert rec == ("held", j // (4 // n), j % (4 // n), True), got
        assert r["held_rows_calls"] > 0


def test_pod_vlm_planted_owner_fails_the_cache_check(runs):
    """Every self layer's owner planted one rank on (``owner + 1``): the
    rows land in the wrong rank's stack, and the layer-by-layer cache
    comparison of the serving test fails on it, while the true run
    passes."""
    want = runs["ref"][PLANT]["serve"]["serving"]["cache"]
    got = _whole(runs["port"][(2, 2, 1)], lambda r: r["planted"])
    errs = FV._by_layer("self/k", got["self/k"],
                        torch.as_tensor(want["self/k"]))
    assert max(errs.values()) > 2e-4, errs
    true = _whole(runs["port"][(2, 2, 1)],
                  lambda r: r[PLANT]["serve"]["serving"]["cache"])
    assert max(FV._by_layer("self/k", true["self/k"], torch.as_tensor(
        want["self/k"])).values()) <= 2e-4


def test_pod_global_norm_counts_each_leaf_once(runs):
    """``global_norm`` of each config's params by ``param_shardings`` on
    both meshes equals the whole tree's: a leaf split over ``data`` or
    ``model`` summed over its ranks, one replicated over ``pod`` (every
    weight) counted once."""
    for mesh in ((2, 2, 1), (2, 1, 2)):
        for r in runs["port"][mesh]:
            for name, j in JOBS.items():
                if j[1] == mesh:
                    got, want, n = r[name]["norm"]
                    assert n >= 10
                    np.testing.assert_allclose(got, want, rtol=1e-6)
