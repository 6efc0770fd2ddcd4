"""Nested remat (``scan_chunks``) under sharded weights, and a replicated
``stage`` axis, on the CPU, held against the JAX package's own sharded
steps.

The port's step builders with ``scan_chunks=2`` on four layouts of
``run_on_local_mesh`` gloo ranks: ``(data 1, model 2)`` (a spawn of 2
ranks), and ``(data 2, model 2)``, ``(pod 2, data 2, model 1)`` and
``(data 2, stage 2, model 1)`` built over the same 4 ranks (one spawn,
its rank mesh the pod layout, whose ``(pod, data)`` line it makes; the
others realised by ``tests/torch_spmd_ranks.py``'s ``_same_ranks``, as
``tests/test_torch_fsdp.py`` builds its pod layout).  The batch is split
over the batch axes by ``distribute_batch``, the weights kept by
``param_shardings`` (a storage-only dim split over ``data``, gathered a
layer inside the layer's checkpoint, which the chunk's checkpoint nests).
The references are the JAX package's jitted ``make_train_step(cfg, mesh,
scan_chunks=2)`` and its ``loss_fn`` gradients through ``LM.apply(...,
scan_chunks=2)``, on the same meshes of 4 forced host devices, in two
subprocesses (``tests/test_torch_fsdp.py``'s JAX script, the option read
from the job's ``kw``), on the same numpy weights and inputs.  The reduced
f32 configs of that file (4 layers): gemma3, musicgen-large's audio path,
moonshot (routing pinned from the JAX package's unsharded forward with the
routing groups of each layout's batch shards), hymba and rwkv at d 256
(the leaves the reference sets to zeros or ones drawn from the seed); B 4
x S 16, loss chunk 8:

* the loss (rtol 1e-5) and every gradient leaf, reassembled, within 2e-4
  of max |reference|, for every family on ``(data 1, model 2)``, on
  ``(data 2, model 2)`` with ``seq_parallel`` on and off, and on ``(pod
  2, data 2, model 1)``; gemma3's two ``make_train_step`` steps on every
  layout, held as ``tests/test_torch_fsdp.py`` holds its steps (the
  params within 1e-4 or twice the JAX package's own unsharded-vs-sharded
  distance, the moments within 1e-4 at their ``opt_shardings`` shapes);
* the nest against no nest: the port's loss and gradients at
  ``scan_chunks`` 2 equal its runs at 0 and at 3 (which 4 layers do not
  divide, so it is ignored) bit for bit, and each weight's ``data``
  gather has its backward once a step, however often the recomputes
  gather it (counted: at 2, each chunk's recompute stops after its
  first layer, torch's early stop); the vlm family's step (which ignores
  ``scan_chunks``, as JAX's ``_apply_vlm`` does) at 2 equals its step at
  0 on every layout with a data axis of 2;
* ``stage``: on ``(data 2, stage 2, model 1)`` the dense, moe and hybrid
  families served (the prefill logits and 2 teacher-forced decode steps
  under both weight layouts, within 2e-4) and their ``scan_chunks=2``
  loss and gradients, against JAX on the same mesh; the two stage
  indices' shards of every result bit-equal (every leaf, moment, batch
  row and cache replicated over ``stage``, as the JAX rules leave them);
  a trained state's ``CheckpointStore`` round trip bit-equal on every
  rank.

Two JAX subprocesses and two spawns, each with a deadline.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models import LM
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import adamw_init

import test_torch_fsdp as F
from test_torch_ep import _err, _param_err, _whole
from torch_spmd_ranks import remat_rank

torch.set_num_threads(1)

B, S, C, N_DEC = F.B, F.S, 2, 2
KW = {**F.KW, "scan_chunks": C}
FAMS = ("dense", "audio", "moe", "hybrid", "ssm")
# layout -> (shape, axes)
LAYOUTS = {"1x2": ((1, 2), ("data", "model")),
           "2x2": ((2, 2), ("data", "model")),
           "pod": ((2, 2, 1), ("pod", "data", "model")),
           "stage": ((2, 2, 1), ("data", "stage", "model"))}
# the spawns: their rank mesh's layout -> the layouts built on its ranks
SPAWNS = {"1x2": ("1x2",), "pod": ("2x2", "pod", "stage")}
# the batch shards of each layout (the moe routing groups)
SHARDS = {"1x2": 1, "2x2": 2, "pod": 4, "stage": 2}
# job -> (config, layout, what runs)
JOBS = {**{f"{f}@{lay}": (f, lay, {"grads": sps})
           for f in FAMS for lay, sps in (("1x2", (True,)),
                                          ("2x2", (True, False)),
                                          ("pod", (True,)))},
        **{f"{f}@stage": (f, "stage", {"grads": (True,), "serve": True,
                                       "ckpt": True})
           for f in ("dense", "moe", "hybrid")}}
for _lay in LAYOUTS:
    JOBS[f"dense@{_lay}"][2]["steps"] = True
VLM = ("llama-3.2-vision-11b", {})


def _vlm_job():
    """The reduced vlm config, its weights and one train batch with image
    embeddings, drawn from a seed (the port alone: the nest against no
    nest)."""
    cfg = get_config(VLM[0]).reduced(**VLM[1])
    g = torch.Generator().manual_seed(5)
    params = LM(cfg).init(g)
    batch = {"ids": torch.randint(0, cfg.vocab, (B, S), generator=g),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=g),
             "mask": (torch.rand((B, S), generator=g) < 0.8).float(),
             "img_embeds": torch.randn((B, cfg.n_img_tokens, cfg.d_model),
                                       generator=g)}
    return cfg, params, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's sharded runs at ``scan_chunks=2`` (two
    subprocesses on 4 forced host devices) and the port's ranks (a spawn
    of 2 and one of 4), which run while the subprocesses do."""
    tmp = tmp_path_factory.mktemp("remat")
    rng = np.random.default_rng(53)
    params, jcfgs, cfgs, draws = {}, {}, {}, {}
    for fam in FAMS:
        arch, over = F.ARCHS[fam]
        jcfgs[fam] = jget_config(arch).reduced(**over)
        cfgs[fam] = get_config(arch).reduced(**over)
        jp = jax.jit(JLM(jcfgs[fam]).init)(jax.random.PRNGKey(0))
        if jcfgs[fam].rwkv or jcfgs[fam].hybrid:
            jp = F._draw_state_leaves(jp, rng)
        params[fam] = (jp, jax.tree.map(np.asarray, jp))
        batches, dec = F._draws(rng, cfgs[fam], B)
        draws[fam] = (batches, dec[:, :N_DEC])
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    jax_runs = []
    parts = (("dense", "audio"), ("moe", "hybrid", "ssm"))
    for i, part in enumerate(parts):
        jobs = {n: {"arch": F.ARCHS[f][0], "overrides": F.ARCHS[f][1],
                    "mesh": LAYOUTS[lay][0], "axes": LAYOUTS[lay][1],
                    "params": params[f][1], "batches": draws[f][0],
                    "dec": draws[f][1], "kw": KW,
                    "runs": tuple(k for k in ("serve", "grads", "steps")
                                  if what.get(k)),
                    "losses": {"total": F.LOSSES["total"]}}
                for n, (f, lay, what) in JOBS.items() if f in part}
        with open(tmp / f"in{i}.pkl", "wb") as fh:
            pickle.dump(jobs, fh)
        jax_runs.append(subprocess.Popen(
            [sys.executable, "-c", F.JAX_SCRIPT, str(tmp / f"in{i}.pkl"),
             str(tmp / f"out{i}.pkl")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        gaps: list = []
        # the routing of each layout's batch shards; the stage layout's
        # serving too (2 shards)
        pins = {n: F._pins(jcfgs["moe"], params["moe"][0], draws["moe"][0],
                           draws["moe"][1] if n == 2 else None, None, gaps, n)
                for n in (1, 2, 4)}
        assert min(gaps) > F.TIE_GAP, f"a near-tie in the routing: {min(gaps)}"
        control = F._unsharded_steps(jcfgs["dense"], params["dense"][0],
                                     draws["dense"][0], kw=KW)

        def port_job(name):
            fam, lay, what = JOBS[name]
            batches, dec = draws[fam]
            return {"cfg": cfgs[fam], "kw": KW, "layout": lay,
                    "params": params_from_numpy(params[fam][1],
                                                cfgs[fam].dtype,
                                                device="cpu"),
                    "batches": [{k: torch.from_numpy(v) for k, v in
                                 b.items()} for b in batches],
                    "dec": torch.from_numpy(dec),
                    "pins": pins[SHARDS[lay]] if fam == "moe" else None,
                    **what}

        port = {}
        for own, keys in SPAWNS.items():
            shape, axes = LAYOUTS[own]
            port[own] = TMESH.run_on_local_mesh(
                shape, axes, remat_rank, {k: LAYOUTS[k] for k in keys},
                {n: port_job(n) for n, j in JOBS.items() if j[1] in keys},
                _vlm_job() if own == "pod" else None, str(tmp / "ckpt"),
                device="cpu", timeout=600)
        ref = {}
        for i, run in enumerate(jax_runs):
            _, err = run.communicate(timeout=900)
            assert run.returncode == 0, err[-3000:]
            with open(tmp / f"out{i}.pkl", "rb") as fh:
                ref.update(pickle.load(fh))
    finally:
        for run in jax_runs:
            run.kill()
    return {"ref": ref, "port": port, "cfgs": cfgs, "control": control}


def _ranks(runs, name) -> list:
    lay = JOBS[name][1]
    own = next(k for k, keys in SPAWNS.items() if lay in keys)
    return [r[name] for r in runs["port"][own]]


def _layout(lay):
    return TMESH.MeshLayout(*LAYOUTS[lay])


GRADS = [(n, sp) for n, j in JOBS.items() for sp in j[2]["grads"]]
GRAD_IDS = [f"{n}-{'seq' if sp else 'noseq'}" for n, sp in GRADS]


@pytest.mark.parametrize("name,sp", GRADS, ids=GRAD_IDS)
def test_scan_chunks_loss_and_gradients_match_jax_sharded(runs, name, sp):
    want_loss, want = runs["ref"][name]["grads"]["total"]
    res = _ranks(runs, name)
    for r in res:
        loss, _, laid_out, _ = r["grads"][sp]["run"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert laid_out
    got = _whole(res, lambda r: r["grads"][sp]["run"][1])
    assert set(got) == set(want)
    errs = {p: _err(got[p], want[p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs


@pytest.mark.parametrize("name,sp", GRADS, ids=GRAD_IDS)
def test_nest_equals_no_nest_bit_for_bit(runs, name, sp):
    """On the same layout the port's loss and gradient shards at
    ``scan_chunks`` 2 equal its runs at 0 and at 3 (ignored: 3 does not
    divide 4 layers), bit for bit, on every rank."""
    for r in _ranks(runs, name):
        assert r["grads"][sp]["equal"] == {0: True, 3: True}


@pytest.mark.parametrize("name,sp", GRADS, ids=GRAD_IDS)
def test_each_data_gather_has_one_backward_a_step(runs, name, sp):
    """Each weight split over ``data`` (every such leaf of the 4 layers,
    and the embed table) is gathered in the forward and again in its
    layer's recompute, and at ``scan_chunks`` 2 once more in its chunk's
    recompute for the chunk's first layer (the recompute stops once the
    chunk's saved tensors are back: the second layer's input); its
    gradient is summed back once a step at 0, 2 and 3 alike.  A data axis
    of 1 gathers nothing."""
    fam, lay, _ = JOBS[name]
    cfg = runs["cfgs"][fam]
    layout = _layout(lay)
    per_layer = embed = 0
    for path, sh in _paths(TS.param_shardings(
            layout, TST.abstract_params(cfg))).items():
        if layout.shape["data"] > 1 and any(
                "data" in (e if isinstance(e, tuple) else (e,))
                for e in sh.spec):
            if path.startswith("layers/"):
                per_layer += 1
            else:
                embed += 1
    L = cfg.n_layers
    assert (per_layer > 0) == (layout.shape["data"] > 1)
    for r in _ranks(runs, name):
        got = r["grads"][sp]["gathers"]
        for c in (0, 2, 3):
            assert got[c]["backward"] == L * per_layer + embed, (c, got)
        assert got[0]["forward"] == got[3]["forward"] == (
            2 * L * per_layer + embed), got
        assert got[2]["forward"] == got[0]["forward"] + (
            L // C * (C - 1) * per_layer), got


def _paths(tree) -> dict:
    out = {}
    TS.map_with_path(lambda p, a: out.__setitem__(TS.path_str(p), a), tree)
    return out


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_scan_chunks_two_train_steps_match_jax_sharded(runs, lay):
    """gemma3's two ``make_train_step(scan_chunks=2)`` steps on each
    layout against JAX's on the same mesh: the metrics (rtol 1e-4,
    grad_norm one number on every rank), the moments within 1e-4 at their
    ``opt_shardings`` local shapes, the params where AdamW's sign is fixed
    within 1e-4, or twice the JAX package's own unsharded-vs-sharded
    distance."""
    name = f"dense@{lay}"
    ref = runs["ref"][name]
    res = _ranks(runs, name)
    layout = _layout(lay)
    whole = TST.abstract_params(runs["cfgs"]["dense"])
    specs = {p: sh.spec for p, sh in _paths(TS.opt_shardings(
        layout, adamw_init(whole), whole).m).items()}
    for r in res:
        st = r["steps"]
        assert st["step_plain"] and st["moments_laid_out"]
        for got, want in zip(st["metrics"], ref["steps"]["metrics"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6)
        for nm in ("m", "v"):
            for path, (local, _, shape) in st[nm].items():
                assert tuple(local.shape) == TS.local_shape(
                    layout, specs[path], shape), (nm, path)
    for i in range(2):
        assert len({r["steps"]["metrics"][i]["grad_norm"] for r in res}) == 1
    g1 = {p: torch.as_tensor(np.asarray(v, np.float32)) for p, v in
          ref["grads"]["total"][1].items()}
    got = _whole(res, lambda r: r["steps"]["params"])
    over = {}
    for p in got:
        err = _param_err(got[p], ref["steps"]["params"][p], g1[p])
        control = _param_err(torch.as_tensor(runs["control"][p]),
                             ref["steps"]["params"][p], g1[p])
        if err > max(1e-4, 2 * control):
            over[p] = (err, control)
    assert not over, over
    for nm in ("m", "v"):
        got = _whole(res, lambda r: r["steps"][nm])
        errs = {p: _err(got[p], ref["steps"][nm][p]) for p in got}
        assert max(errs.values()) <= 1e-4, (nm, errs)


@pytest.mark.parametrize("lay", ["2x2", "pod", "stage"])
def test_vlm_ignores_scan_chunks(runs, lay):
    """The vlm family checkpoints each group and ignores ``scan_chunks``,
    as JAX's ``_apply_vlm`` does: its train step at 2 equals its step at
    0 bit for bit (the metrics, params and moments) on every rank."""
    for r in runs["port"]["pod"]:
        equal, loss = r["vlm"][lay]
        assert equal and np.isfinite(loss)


STAGE = [n for n, j in JOBS.items() if j[1] == "stage"]


@pytest.mark.parametrize("name,layout", [(n, s) for n in STAGE
                                         for s in ("serving", "fsdp")],
                         ids=[f"{n}-{s}" for n in STAGE
                              for s in ("serving", "fsdp")])
def test_stage_serving_matches_jax(runs, name, layout):
    """On (data 2, stage 2, model 1): the prefill logits, 2 teacher-forced
    decode steps and every cache leaf within 2e-4 of JAX's on the same
    mesh, each cache leaf at JAX's shard shape (B split over data, every
    leaf whole over stage)."""
    ref = runs["ref"][name]["serve"][layout]
    got = [r["serve"][layout] for r in _ranks(runs, name)]
    logits = _whole(got, lambda g: {"x": g["logits"]})["x"]
    assert _err(logits, ref["logits"]) <= 2e-4
    for j in range(N_DEC):
        dec = _whole(got, lambda g: {"x": g["decode"][j]})["x"]
        assert _err(dec, ref["decode"][j]) <= 2e-4
    cache = _whole(got, lambda g: g["cache"])
    assert set(cache) == set(ref["cache"])
    for path in cache:
        assert _err(cache[path], ref["cache"][path]) <= 2e-4, path
    for g in got:
        assert g["laid_out"] and g["input_local"][0] == B // 2
        for path, (local, _, _) in g["cache"].items():
            assert tuple(local.shape) == ref["cache_local"][path], path


@pytest.mark.parametrize("name", STAGE)
def test_stage_indices_hold_the_same_bits(runs, name):
    """The two ranks of each ``stage`` line (the same data index) hold the
    same gradient shards, the same trained state and the same served
    logits and cache, bit for bit: ``stage`` splits nothing."""
    coord = [r["coord"]["stage"] for r in runs["port"]["pod"]]
    res = _ranks(runs, name)
    pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)
             if coord[a][0] == coord[b][0]]
    assert len(pairs) == 2 and all(coord[a][1] != coord[b][1]
                                   for a, b in pairs)

    def same(x, y) -> bool:
        return x.keys() == y.keys() and all(
            torch.equal(x[p][0], y[p][0]) and x[p][1] == y[p][1] for p in x)

    for a, b in pairs:
        ra, rb = res[a], res[b]
        assert ra["grads"][True]["run"][0] == rb["grads"][True]["run"][0]
        assert same(ra["grads"][True]["run"][1], rb["grads"][True]["run"][1])
        assert same(ra["ckpt"]["trained"], rb["ckpt"]["trained"])
        for lay in ("serving", "fsdp"):
            sa, sb = ra["serve"][lay], rb["serve"][lay]
            assert torch.equal(sa["logits"][0], sb["logits"][0])
            assert same(sa["cache"], sb["cache"])


@pytest.mark.parametrize("name", STAGE)
def test_stage_checkpoint_round_trip_is_bit_equal(runs, name):
    """A ``scan_chunks=2`` trained state on (data 2, stage 2, model 1)
    saved by ``CheckpointStore`` (global rank 0 writing once) and restored
    by ``shardings=``: every rank's placements and local tensors equal
    its trained state's, bit for bit."""
    for r in _ranks(runs, name):
        assert r["ckpt"]["equal"]
