"""The checkpoint store on a sharded train state, on the CPU.

``CheckpointStore`` of the port on the gloo ranks of ``run_on_local_mesh``
(the rank body is ``tests/torch_spmd_ranks.py``'s ``ckpt_rank``): a reduced
bf16 gemma3 trained one ``make_train_step`` step under ``(data 2, model
2)`` and under ``(pod 2, data 2, model 1)``, its params by
``param_shardings`` and moments by ``opt_shardings`` (DTensor leaves, the
step a plain tensor), is saved by every rank (each DTensor leaf gathered
whole, global rank 0 writing) and restored:

* by ``shardings=``: each rank's local tensors and placements equal the
  saved ones bit for bit, the step a plain tensor;
* with ``shardings=None``: every leaf whole, a plain tensor, whose slice
  at the rank's bounds is its shard;
* ``latest_step()`` agrees on every rank after ``save`` and after
  ``save_async`` and ``wait``;
* a checkpoint that the JAX package's store saved from a state on a mesh
  of the same shape of 4 forced host devices (a subprocess, one train
  step, placed by ``train_state_structs``) restores into the port's
  DTensor layout, each leaf equal to the JAX state's;
* the port's checkpoint restores in the JAX package by ``shardings=``
  (another subprocess) to the same values, each shard shape the port's
  local shape;
* a planted fault, one rank's shard read one row off its bounds, fails
  the comparison.

Two JAX subprocesses and two spawns (one a mesh), each with a deadline.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.models.transformer import params_from_numpy

from test_torch_ep import _whole
from torch_spmd_ranks import ckpt_rank

torch.set_num_threads(1)

ARCH, OVER = "gemma3-12b", dict(vocab=250, dtype="bfloat16")
B, S = 4, 16
KW = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=8)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}

JAX_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.launch.steps as JST
    from repro.checkpoint import CheckpointStore
    from repro.configs import get_config
    from repro.launch.mesh import _mesh
    from repro.launch.sharding import batch_spec, guard_spec
    from repro.optim import adamw_init

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in p): np.asarray(v, np.float32)
                for p, v in flat}

    job = pickle.load(open(sys.argv[1], "rb"))
    cfg = get_config(job["arch"]).reduced(**job["overrides"])
    out = {}
    for name, (shape, axes) in job["meshes"].items():
        mesh = _mesh(shape, axes)
        structs, sh = JST.train_state_structs(cfg, mesh)
        r = out[name] = {}
        if job["what"] == "save":
            p = jax.device_put(jax.tree.map(jnp.asarray, job["params"]),
                               sh["params"])
            state = {"params": p, "opt": jax.device_put(
                adamw_init(job["params"]), sh["opt"])}
            _, step = JST.make_train_step(cfg, mesh, seq_parallel=True,
                                          **job["kw"])

            def put(a):
                spec = guard_spec(mesh, P(batch_spec(mesh)[0]), a.shape)
                return jax.device_put(jnp.asarray(a),
                                      NamedSharding(mesh, spec))

            state, _ = jax.jit(step)(state, {k: put(v) for k, v in
                                             job["batch"].items()})
            CheckpointStore(job["roots"][name]).save(1, state,
                                                     {"next_step": 1})
            r["state"] = paths(state)
        else:
            got, extra = CheckpointStore(job["roots"][name]).restore(
                None, like=structs, shardings=sh)
            r["state"] = paths(got)
            r["extra"] = extra
            r["shard_shapes"] = {
                q: tuple(a.sharding.shard_shape(a.shape)) for q, a in
                zip(paths(got), jax.tree.leaves(got))}
            r["placed"] = all(a.sharding == s for a, s in zip(
                jax.tree.leaves(got), jax.tree.leaves(sh)))
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _jax(tmp, what: str, job: dict) -> dict:
    """Run :data:`JAX_SCRIPT` on ``job`` (``what``: "save" or "restore")
    in a subprocess with a deadline."""
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    with open(tmp / f"{what}_in.pkl", "wb") as f:
        pickle.dump({**job, "what": what}, f)
    run = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / f"{what}_in.pkl"),
         str(tmp / f"{what}_out.pkl")], env=env, capture_output=True,
        text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(tmp / f"{what}_out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's checkpoints of its sharded states, the port's
    ranks on both meshes (each saving its own and restoring JAX's), and
    the JAX package's restore of the port's."""
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    jc = jget_config(ARCH).reduced(**OVER)
    cfg = get_config(ARCH).reduced(**OVER)
    jp = jax.tree.map(np.asarray, jax.jit(JLM(jc).init)(
        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(53)
    batch = {"ids": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    job = {"arch": ARCH, "overrides": OVER, "params": jp, "batch": batch,
           "kw": KW, "meshes": MESHES,
           "roots": {n: str(tmp / f"jax_{n}") for n in MESHES}}
    theirs = _jax(tmp, "save", job)
    params = params_from_numpy(jp, cfg.dtype, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = {n: TMESH.run_on_local_mesh(
        shape, axes, ckpt_rank, cfg, params, tbatch, KW, str(tmp / n),
        job["roots"][n], device="cpu", timeout=300)
        for n, (shape, axes) in MESHES.items()}
    back = _jax(tmp, "restore", {**job, "roots": {n: str(tmp / n)
                                                  for n in MESHES}})
    return {"port": port, "jax_saved": theirs, "jax_restored": back}


def _same(a: dict, b: dict) -> bool:
    """Two ranks' shard records (path -> (local, bounds, shape)) equal bit
    for bit, bounds and shapes too."""
    return set(a) == set(b) and all(
        a[p][1] == b[p][1] and a[p][2] == b[p][2]
        and a[p][0].dtype == b[p][0].dtype and torch.equal(a[p][0], b[p][0])
        for p in a)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_state_restores_by_shardings_bit_for_bit(runs, mesh):
    """Every rank's restored local tensors equal the saved ones bit for
    bit, each leaf a DTensor where the saved one is, with its placements
    and bounds; the step a plain tensor; the extra dict back."""
    for r in runs["port"][mesh]:
        assert _same(r["restored"], r["saved"])
        assert r["laid_out"] and r["bounds_equal"] and r["step_plain"]
        assert r["extra"] == {"next_step": 1}
    assert any(at[d].stop - at[d].start < n for _, at, shape in
               runs["port"][mesh][0]["saved"].values()
               for d, n in enumerate(shape))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_plain_restore_gives_whole_leaves(runs, mesh):
    """``shardings=None``: every leaf whole and a plain tensor (as JAX's
    ``device_put(a)``); its slice at each rank's bounds is that rank's
    shard, and the whole is the ranks' shards reassembled."""
    res = runs["port"][mesh]
    saved = _whole(res, lambda r: r["saved"])
    for r in res:
        assert r["whole_plain"]
        for path, (local, at, _) in r["saved"].items():
            assert torch.equal(r["whole"][path][at], local), path
            assert torch.equal(r["whole"][path].float(), saved[path]), path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_latest_step_agrees_on_every_rank(runs, mesh):
    """After ``save`` every rank reads step 1 as the latest, and after
    ``save_async`` and ``wait`` step 2: rank 0 writes, the others wait at
    the barrier that follows its rename."""
    assert {tuple(r["latest"]) for r in runs["port"][mesh]} == {(1, 2)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_jax_sharded_checkpoint_restores_into_the_dtensor_layout(runs,
                                                                   mesh):
    """The JAX package's store saved its sharded state (4 forced host
    devices, a mesh of the same shape): restored by the port's
    ``shardings=``, each rank's shards lie at the port's bounds and
    reassemble to the JAX state, every leaf equal."""
    res = runs["port"][mesh]
    want = runs["jax_saved"][mesh]["state"]
    got = _whole(res, lambda r: r["jax"])
    assert set(got) == set(want)
    for path in got:
        np.testing.assert_array_equal(got[path].numpy(), want[path],
                                      err_msg=path)
    for r in res:
        for path, (local, at, shape) in r["jax"].items():
            assert (at, shape) == r["saved"][path][1:], path
            assert local.dtype == r["saved"][path][0].dtype, path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_ports_sharded_checkpoint_restores_in_jax_by_shardings(runs,
                                                                   mesh):
    """The port's latest checkpoint (step 2, by ``save_async``, of the
    state after the train step) restores in the JAX package by
    ``shardings=`` (``train_state_structs``'s) to the port's state, each
    leaf equal, placed by its sharding, each shard shape the port's local
    shape."""
    res = runs["port"][mesh]
    back = runs["jax_restored"][mesh]
    assert back["placed"] and back["extra"] == {"next_step": 2}
    saved = _whole(res, lambda r: r["saved"])
    assert set(back["state"]) == set(saved)
    for path, want in saved.items():
        np.testing.assert_array_equal(back["state"][path], want.numpy(),
                                      err_msg=path)
        assert back["shard_shapes"][path] == tuple(
            res[0]["saved"][path][0].shape), path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_shard_offset_by_one_row_fails_the_check(runs, mesh):
    """The comparison catches a planted fault: rank 1's shard of a split
    leaf read one row off its bounds (along its split dim) differs from
    the saved shard, while every other rank's planted record is its true
    one."""
    for r in runs["port"][mesh]:
        assert _same(r["planted"], r["saved"]) == (r is not
                                                   runs["port"][mesh][1])
