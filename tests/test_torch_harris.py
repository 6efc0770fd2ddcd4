"""The port's Harris kernels and software rows held against the JAX package.

The same numpy inputs go through ``repro`` and ``repro_torch``:

* K1 cvtColor and K3 convertScaleAbs against the Pallas kernels in
  interpret mode and the jnp rows;
* K2 cornerHarris and K4 (the fused module) against the jnp rows of
  ``repro.models.harris`` and their composition — the Pallas K2 and K4 do
  not run under the installed JAX;
* every entry of the port's database against the JAX database's software
  rows, over the grid the JAX package's differential test uses.

On the CPU each wrapper takes its plain version; the kernels themselves
run only on the card (``tests/test_torch_cuda.py``), where they are held to
those same plain versions.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.kernels.harris as jk
import repro.models.harris as jmh
from repro_torch.core.costmodel import FUSED_TILE, SMEM_BYTES
from repro_torch.kernels import harris as hk
from repro_torch.kernels.autotune import AutotuneCache, autotune
from repro_torch.models import harris as mh

torch.set_num_threads(1)

# the grids of tests/test_kernels.py and tests/test_database_diff.py
CVT_SHAPES = [(8, 128), (64, 256), (33, 130), (17, 23), (13, 40)]
HARRIS_SHAPES = [(16, 128), (64, 256), (40, 136), (16, 32), (17, 23),
                 (13, 40)]
CSA_PARAMS = [(1.0, 0.0), (0.01, 5.0), (-2.0, 100.0)]


def _img(seed, h, w, c=3):
    rng = np.random.default_rng(seed)
    shape = (h, w, c) if c else (h, w)
    return (rng.random(shape, dtype=np.float32) * 255).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close_scaled(got, want, atol=1e-5):
    """Harris responses: compare after dividing both by max |reference|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# --------------------------------------------------------------------------- #
# kernels (CPU path = plain versions) against the JAX package
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("H,W", CVT_SHAPES)
def test_cvt_color_matches_jax(H, W):
    img = _img(H * 1000 + W, H, W)
    got = hk.cvt_color(_t(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.cvt_color(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, np.asarray(jmh.cvt_color(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("H,W", HARRIS_SHAPES)
@pytest.mark.parametrize("block_size", [2, 3])
def test_corner_harris_matches_jax(H, W, block_size):
    gray = np.asarray(jmh.cvt_color(jnp.asarray(_img(H + W, H, W))))
    want = jmh.corner_harris(jnp.asarray(gray), block_size)
    _close_scaled(hk.corner_harris(_t(gray), block_size).numpy(), want)


@pytest.mark.parametrize("alpha,beta", CSA_PARAMS)
def test_convert_scale_abs_matches_jax(alpha, beta):
    x = (np.random.default_rng(7).standard_normal((32, 128)) * 300
         ).astype(np.float32)
    got = hk.convert_scale_abs(_t(x), alpha, beta).numpy()
    for want in (jk.convert_scale_abs(jnp.asarray(x), alpha, beta),
                 jmh.convert_scale_abs(jnp.asarray(x), alpha, beta)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("H,W", [(16, 32), (17, 23), (33, 130)])
@pytest.mark.parametrize("block_size", [2, 3])
@pytest.mark.parametrize("with_csa", [False, True])
def test_harris_fused_matches_jnp_composition(H, W, block_size, with_csa):
    # the gray plane comes from the port's cvtColor (held to the JAX one
    # above): einsum and the three-term sum round differently in the last
    # bit, and the epilogue scales the response far enough to show it
    img = _img(3 * H + W, H, W)
    gray = jnp.asarray(hk.cvt_color(_t(img)).numpy())
    want = jmh.corner_harris(gray, block_size)
    if with_csa:
        want = jmh.convert_scale_abs(want, 1e-6, 3.0)
    got = hk.harris_fused(_t(img), block_size, alpha=1e-6, beta=3.0,
                          with_csa=with_csa).numpy()
    if with_csa:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-3)
    else:
        _close_scaled(got, want)


def test_normalize_matches_jax():
    x = (np.random.default_rng(3).standard_normal((17, 23)) * 1e6
         ).astype(np.float32)
    np.testing.assert_allclose(mh.normalize(_t(x)).numpy(),
                               np.asarray(jmh.normalize(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


# --------------------------------------------------------------------------- #
# every database entry, hw (CPU path) and sw, against the JAX software rows
# --------------------------------------------------------------------------- #
def _jax_row(db, name):
    """The JAX database's software function for ``name`` (a fused key
    composes its parts, as the JAX database's fused fallback does)."""
    return db.lookup(name).software


def test_database_entries_match_jax_rows():
    port = mh.make_harris_db(with_hw=True)
    ref = jmh.make_harris_db(with_hw=False)
    ref.register_fused(("cvtColor", "cornerHarris"), accelerated=None)
    ref.register_fused(("cvtColor", "cornerHarris", "convertScaleAbs"),
                       accelerated=None)
    assert port.names() == sorted(ref.entries)          # registration gate
    for name in port.names():
        rgb = name.startswith("cvtColor")
        for i, (h, w) in enumerate([(16, 32), (17, 23), (13, 40)]):
            x = _img(100 + i, h, w, 3 if rgb else None)
            want = np.asarray(_jax_row(ref, name)(jnp.asarray(x)))
            e = port.lookup(name)
            for fn in filter(None, (e.software, e.accelerated)):
                got = fn(_t(x)).numpy()
                if name.endswith("cornerHarris"):
                    _close_scaled(got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5,
                                               atol=1e-3, err_msg=name)


def test_cpu_wrappers_launch_nothing():
    before = dict(hk.LAUNCHES)
    img = _t(_img(1, 9, 11))
    hk.convert_scale_abs(hk.corner_harris(hk.cvt_color(img)))
    hk.harris_fused(img)
    assert hk.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        hk.cvt_color(torch.empty((4, 4, 3), device="meta"))


# --------------------------------------------------------------------------- #
# tile choice: the shared-memory gate the fusion relies on
# --------------------------------------------------------------------------- #
def test_fused_tile_at_paper_size_fits_shared_memory(tmp_path):
    cache = AutotuneCache(str(tmp_path))
    for bs in (2, 3):
        tile = hk.fused_tile(1080, 1920, bs, cache=cache)
        assert tile == FUSED_TILE
        assert hk.tile_smem_bytes(*tile, bs) <= SMEM_BYTES
        assert hk.tile_score((128, 128), 1080, 1920, bs) == float("inf")
    assert cache.misses == 2
    assert hk.fused_tile(1080, 1920, 2, cache=cache) == FUSED_TILE
    assert cache.hits == 1
    # the cache key names the card the tile was tuned for
    assert all("h100-prior,sm_90" in k for k in cache._load())


def test_autotune_cache_hit_miss_and_persistence(tmp_path):
    cache = AutotuneCache(str(tmp_path))
    calls = []

    def score(c):
        calls.append(c)
        return float(c[0] * c[1])

    cands = [[16, 32], [8, 32], [32, 32]]
    r1 = autotune("k", (64, 128), cands, score, cache=cache)
    assert (r1.best, r1.source, len(calls)) == ([8, 32], "tuned", 3)
    r2 = autotune("k", (64, 128), cands, score, cache=AutotuneCache(str(tmp_path)))
    assert (r2.best, r2.source, len(calls)) == ([8, 32], "cache", 3)
    r3 = autotune("k", (64, 128), [[1, 1], [2, 2]],
                  lambda c: float("inf"), cache=cache)
    assert r3.best == [1, 1]                 # all infeasible: first candidate
