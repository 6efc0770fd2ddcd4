"""The port's SPMD token pipeline on the CPU, held against the JAX package.

* the building blocks, as ``tests/test_pipeline_exec.py`` tests JAX's:
  ``stack_stage_params`` pads and counts (and refuses bad boundaries),
  ``stage_apply`` skips the padding layers, ``spmd_pipeline_fn`` with one
  stage retires every microbatch with all layers applied;
* ``pipeline_microbatches`` on 4 gloo ranks with the unequal boundaries
  [0, 2, 5, 7] (L 9, d 8, M 5, mb 2) against the JAX
  ``pipeline_microbatches`` on 8 forced host devices in a subprocess
  (arrays through an ``.npz``): outputs to 2e-5, and the gradient of
  mean(out²) to rtol 1e-4 / atol 1e-5 on every rank — JAX's, not S times
  it;
* the elastic re-plan: ``ElasticPlanner.boundaries(3)`` equals JAX's on
  the same costs, and a 3-rank pipeline on them equals the sequential
  stack; a (data 2, stage 2) mesh with ``batch_axis`` likewise.

Every multi-process run has a deadline (``run_on_local_mesh(timeout=)``,
the subprocess's ``timeout``), so a hang fails the test.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import linear_ir as j_linear_ir
from repro.runtime import ElasticPlanner as JElasticPlanner
from repro_torch.core import (linear_ir, spmd_pipeline_fn, stack_stage_params,
                              stage_apply)
from repro_torch.launch.mesh import run_on_local_mesh
from repro_torch.runtime import ElasticPlanner

from torch_spmd_ranks import pipeline_rank, sleeping_rank

torch.set_num_threads(1)

L, D, M, MB = 9, 8, 5, 2
BOUNDS = [0, 2, 5, 7]


def test_stack_stage_params_pads_and_counts():
    params = {"w": torch.arange(5.0).reshape(5, 1)}
    staged, lengths = stack_stage_params(params, [0, 3])
    assert staged["w"].shape == (2, 3, 1)          # padded to Lmax=3
    assert lengths.tolist() == [3, 2]
    assert staged["w"][1, :, 0].tolist() == [3.0, 4.0, 0.0]
    with pytest.raises(ValueError, match="start at 0"):
        stack_stage_params(params, [1, 3])
    with pytest.raises(ValueError, match="empty stage"):
        stack_stage_params(params, [0, 5])


def test_stage_apply_masks_padding_layers():
    def block(p, h):
        return h + p["b"]
    stage_params = {"b": torch.tensor([1.0, 10.0, 100.0])}
    assert float(stage_apply(block, stage_params, 3, torch.zeros(()))) == 111
    # the masked tail layer (the 100.0) must not run
    assert float(stage_apply(block, stage_params, torch.tensor(2),
                             torch.zeros(()))) == 11.0


def test_spmd_pipeline_fn_matches_sequential_with_one_stage():
    """One stage outside a mesh (no hand-off): every microbatch retires
    with all L layers applied in order."""
    params = {"b": torch.arange(1.0, 5.0)}          # layer i adds i+1
    staged, lengths = stack_stage_params(params, [0])

    def block(p, h):
        return h + p["b"]
    xs = torch.arange(6.0).reshape(3, 2)
    out = spmd_pipeline_fn(block, 1)(staged, lengths, xs)
    assert out.shape == (3, 2)
    torch.testing.assert_close(out, xs + params["b"].sum())
    with pytest.raises(RuntimeError, match="run_on_local_mesh"):
        spmd_pipeline_fn(block, 2)(staged, lengths, xs)


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.core import pipeline_microbatches

    d = np.load(sys.argv[1])
    W, xs = jnp.asarray(d["W"]), jnp.asarray(d["xs"])
    bounds = [int(b) for b in d["bounds"]]
    mesh = jax.make_mesh((len(bounds),), ("stage",),
                         axis_types=(AxisType.Auto,))
    block = lambda p, x: jnp.tanh(x @ p["w"])
    out = pipeline_microbatches(mesh, block, {"w": W}, bounds, xs)
    loss = lambda p: jnp.mean(
        pipeline_microbatches(mesh, block, p, bounds, xs) ** 2)
    g = jax.grad(loss)({"w": W})["w"]
    np.savez(sys.argv[2], out=np.asarray(out), grad=np.asarray(g))
""")


def _inputs():
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return W, xs


def test_pipeline_microbatches_on_4_gloo_ranks_matches_jax(tmp_path):
    W, xs = _inputs()
    np.savez(tmp_path / "in.npz", W=W, xs=xs, bounds=np.array(BOUNDS))
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp_path / "in.npz"),
         str(tmp_path / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        res = run_on_local_mesh((4,), ("stage",), pipeline_rank,
                                torch.from_numpy(W), torch.from_numpy(xs),
                                BOUNDS, device="cpu", timeout=120)
        _, err = jax_run.communicate(timeout=300)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, err[-2000:]
    want = np.load(tmp_path / "jax.npz")
    for r in res:
        np.testing.assert_allclose(r["out"].numpy(), want["out"], rtol=2e-5,
                                   atol=2e-5)
        # every rank holds the whole gradient, JAX's (not S times it)
        np.testing.assert_allclose(r["grad"].numpy(), want["grad"],
                                   rtol=1e-4, atol=1e-5)
    assert [r["stats"]["layers"] for r in res] == [2, 3, 2, 2]
    assert [r["stats"]["stage"] for r in res] == [0, 1, 2, 3]


def _sequential(W, xs):
    W = W.clone().requires_grad_(True)
    h = xs
    for i in range(W.shape[0]):
        h = torch.tanh(h @ W[i])
    (h.float() ** 2).mean().backward()
    return h.detach(), W.grad


def test_elastic_replan_to_3_stages_and_a_data_axis():
    costs = [1.0, 1.0, 4.0, 1.0, 1.0, 1.0, 3.0, 1.0, 2.0]
    b3 = ElasticPlanner(linear_ir("layers", [f"L{i}" for i in range(L)],
                                  costs), device="cpu").boundaries(3)
    jb3 = JElasticPlanner(j_linear_ir("layers", [f"L{i}" for i in range(L)],
                                      costs)).boundaries(3)
    assert b3 == jb3 and len(b3) == 3
    W, xs = (torch.from_numpy(a) for a in _inputs())
    out, grad = _sequential(W, xs)
    res = run_on_local_mesh((3,), ("stage",), pipeline_rank, W, xs, b3,
                            device="cpu", timeout=120)
    for r in res:
        torch.testing.assert_close(r["out"], out, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(r["grad"], grad, rtol=1e-4, atol=1e-5)
    # data parallel x pipeline: the microbatch dim split over "data"
    xs4 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 4, D)).astype(np.float32))
    out4, grad4 = _sequential(W, xs4)
    res = run_on_local_mesh((2, 2), ("data", "stage"), pipeline_rank, W, xs4,
                            [0, 4], "data", device="cpu", timeout=120)
    for r in res:
        torch.testing.assert_close(r["out"], out4, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(r["grad"], grad4, rtol=1e-4, atol=1e-5)
    assert sorted(r["coord"] for r in res) == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]


def test_a_failed_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="boundaries"):
        run_on_local_mesh((2,), ("stage",), pipeline_rank,
                          torch.zeros((3, 2, 2)), torch.zeros((2, 1, 2)),
                          [0, 1, 2], device="cpu", timeout=60)


def test_a_hung_rank_fails_the_call_at_its_deadline():
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_on_local_mesh((2,), ("stage",), sleeping_rank, 1, device="cpu",
                          timeout=20)
    assert time.monotonic() - t0 < 40
