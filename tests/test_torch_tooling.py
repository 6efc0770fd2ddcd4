"""The port's tooling on the CPU: ``AutotuneCache.clear``/``info`` held to
the JAX package's class on the same key sequence, and the two examples
(``examples/torch_serve_batched.py``, ``examples/torch_train_100m.py``)
run as subprocesses with ``--device cpu`` at a few steps."""
import os
import subprocess
import sys

import pytest

from repro.kernels.autotune import AutotuneCache as JCache
from repro_torch.kernels.autotune import AutotuneCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drive(cache) -> list:
    """A key sequence through ``cache``: what each call returns (``info``
    without its path, beside whether the file exists)."""
    out = []
    for op, *args in [("get", "a"), ("put", "a", {"best": [8, 64]}),
                      ("get", "a"), ("get", "b"), ("put", "b", 3),
                      ("info",), ("clear",), ("info",), ("get", "a"),
                      ("put", "c", {"best": 1}), ("info",), ("clear",),
                      ("clear",), ("info",)]:
        got = getattr(cache, op)(*args)
        if op == "info":
            assert got["path"] == cache.file
            got = {k: v for k, v in got.items() if k != "path"}
        out.append((op, got, os.path.exists(cache.file)))
    return out


def test_autotune_cache_clear_and_info_match_jax(tmp_path):
    mine = _drive(AutotuneCache(str(tmp_path / "port")))
    assert mine == _drive(JCache(str(tmp_path / "jax")))
    assert mine[5] == ("info", {"entries": 2, "hits": 1, "misses": 2}, True)
    assert mine[7] == ("info", {"entries": 0, "hits": 1, "misses": 2}, False)


def _run(script, *args):
    env = {**os.environ,
           "PYTHONPATH": os.path.join(ROOT, "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script), *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("mode", ["lm", "pipeline"])
def test_serve_batched_example_runs_on_the_cpu(mode):
    args = (["--tokens", "4"] if mode == "lm"
            else ["--mode", "pipeline", "--requests", "8", "--max-batch", "4"])
    out = _run("torch_serve_batched.py", "--device", "cpu", *args)
    if mode == "lm":
        assert "arch=gemma3-12b layers=4" in out and "[serve] decode:" in out
    else:
        assert "results match the plain app: True" in out


def test_train_100m_example_runs_on_the_cpu(tmp_path):
    out = _run("torch_train_100m.py", "--device", "cpu", "--steps", "6",
               "--batch", "2", "--seq-len", "32", "--ckpt-dir",
               str(tmp_path / "ckpt"))
    assert "OK: loss decreased" in out and "steps=6" in out
