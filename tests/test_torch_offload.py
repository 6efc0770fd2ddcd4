"""The port's whole Harris offload path held against the JAX package.

``courier_offload(corner_harris_demo(Library(db)), frame, db=make_harris_db())``
on the port, with and without fusion, equals the JAX package's jnp app on
the same numpy frame, with the Off-load Switcher's logs empty.  Also: the
Switcher still falls back (visibly) when a module fails, importing the port
loads no JAX, and the entry points run on the card unless asked for the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.models.harris as jmh
from repro_torch import quickstart
from repro_torch.core import Library, courier_offload, deploy
from repro_torch.models import harris as mh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 3), dtype=np.float32) * 255).astype(np.float32)
            for _ in range(n)]


def _jax_app():
    return jmh.corner_harris_demo(jcore.Library(jmh.make_harris_db(with_hw=False)))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("policy", ["paper", "optimal"])
def test_offload_equals_jax_app(fuse, policy):
    frames = _frames(3, 32, 64)
    db = mh.make_harris_db(with_hw=True)
    app = mh.corner_harris_demo(Library(db))
    off = courier_offload(app, torch.from_numpy(frames[0]), db=db, fuse=fuse,
                          policy=policy)
    fused = [n.fn_key for n in off.pipeline.ir.nodes if n.fused_from]
    assert fused == (["cvtColor+cornerHarris"] if fuse else [])
    jax_app = _jax_app()
    tok = [torch.from_numpy(f) for f in frames]
    for got in (off(tok[0]), off.map(tok)[0], off.pipeline.run_sequential(tok)[0]):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax_app(jnp.asarray(frames[0]))),
                                   rtol=1e-4, atol=1e-4)
    for got, f in zip(off.map(tok), frames):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_app(jnp.asarray(f))),
                                   rtol=1e-4, atol=1e-4)
    assert off.fallbacks == [] and off.plan.fallback_log == []
    assert all(sf.compiles == 0 for sf in off.pipeline.stage_fns)


def test_deploy_rebinds_the_unmodified_app():
    frame = torch.from_numpy(_frames(1, 17, 23)[0])
    db = mh.make_harris_db(with_hw=True)
    app = mh.corner_harris_demo(Library(db))
    off = courier_offload(app, frame, db=db)
    assert off.plan.decisions == {"cvtColor": "hw", "cornerHarris": "hw",
                                  "normalize": "sw", "convertScaleAbs": "hw"}
    with deploy(off.plan):
        got = app(frame)
    torch.testing.assert_close(got, app(frame), rtol=1e-4, atol=1e-4)
    assert off.plan.fallback_log == []


def test_switcher_falls_back_and_logs():
    """A module that fails is replaced by the original, and the logs say so
    (the kernel wrappers themselves never fall back)."""
    frame = torch.from_numpy(_frames(1, 16, 24)[0])
    db = mh.make_harris_db(with_hw=True)

    def broken(gray, block_size=2, k=0.04):
        raise RuntimeError("module fault")
    db.add_accelerated("cornerHarris", broken)
    app = mh.corner_harris_demo(Library(db))
    off = courier_offload(app, frame, db=db)
    torch.testing.assert_close(off(frame), app(frame))
    assert len(off.fallbacks) == 1 and "module fault" in off.fallbacks[0]
    with deploy(off.plan):
        app(frame)
    assert off.plan.fallback_log == ["cornerHarris: RuntimeError: module fault"]


def test_import_loads_no_jax_and_no_reference_package():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.analysis, "
            "repro_torch.kernels.harris, repro_torch.kernels.build, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.ops, "
            "repro_torch.models.harris, repro_torch.models.zoo, "
            "repro_torch.configs.harris, repro_torch.configs.deepseek_67b, "
            "repro_torch.configs, repro_torch.kernels.flash_attention, "
            "repro_torch.models.config, repro_torch.models.layers, "
            "repro_torch.models.transformer, "
            "repro_torch.core.executor, repro_torch.core.profiler, "
            "repro_torch.runtime.faults, repro_torch.launch.serve, "
            "repro_torch.quickstart, repro_torch.optim, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.runtime.driver, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.core.tree\n"
            "repro_torch.configs.all_configs()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert mh.make_frames(1, 4, 4)[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mh.make_frames(1, 4, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            quickstart.main([])
    (f,) = mh.make_frames(1, 4, 5, device="cpu")
    assert f.shape == (4, 5, 3) and f.dtype == torch.float32


def test_quickstart_runs_on_the_cpu_when_asked(capsys):
    quickstart.main(["--device", "cpu", "--height", "24", "--width", "40",
                     "--frames", "2", "--fuse"])
    out = capsys.readouterr().out
    assert "semantics preserved" in out and "cvtColor+cornerHarris" in out
