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


# --------------------------------------------------------------------------- #
# the CUDA kernels' walks, emulated in torch (the kernels run only on the
# card; these hold their index arithmetic and order of operations)
# --------------------------------------------------------------------------- #
def _clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def _copy_tile(flat, H, W, C, y0, x0, GH, L, vec):
    """``copy_tile`` of harris.cu: thread i walks (row, 16-byte vector)
    from divmod(i, vectors a row) in steps of TILE_THREADS; a vector wholly
    inside the image is one 16-byte copy, any other four clamped 4-byte
    copies.  Returns the stage and how often each float was copied."""
    stage = torch.full((GH, L), float("nan"))
    copies = torch.zeros((GH, L), dtype=torch.int64)
    nv = L // 4
    row_step, v_step = divmod(hk.TILE_THREADS, nv)
    for i in range(hk.TILE_THREADS):
        r, v = divmod(i, nv)
        while r < GH:
            row = flat[_clamp(y0 - hk.HALO + r, 0, H - 1)]
            f = 4 * v
            c = (x0 - hk.PAD_X) * C + f
            if vec and c >= 0 and c + 4 <= W * C:
                stage[r, f:f + 4] = row[c:c + 4]
                copies[r, f:f + 4] += 1
            else:
                for j in range(4):
                    p = (f + j) // C
                    stage[r, f + j] = row[_clamp(x0 - hk.PAD_X + p, 0, W - 1)
                                          * C + f + j - p * C]
                    copies[r, f + j] += 1
            v += v_step
            if v >= nv:
                v -= nv
                r += 1
            r += row_step
    return stage, copies


def _micro_tiles(g, origins, bs, k):
    """``micro_tile`` of harris.cu for every (oy, ox) in ``origins`` at
    once, op for op: gray rows streamed three at a time, the Sobel products
    of each product row, box sums by rows then columns from 0.0, then
    det - k * tr^2.  Returns [n, MY, MX] responses."""
    my_, mx_ = hk.MICRO_TILE
    rows = torch.stack([torch.stack([g[oy + r, ox:ox + 12]
                                     for r in range(my_ + bs + 1)])
                        for oy, ox in origins])          # [n, rows, 12]
    zero = torch.zeros(len(origins))
    s = {q: [[zero for _ in range(mx_)] for _ in range(my_)]
         for q in ("xx", "yy", "xy")}
    for py in range(my_ + bs - 1):
        a, b, c = rows[:, py], rows[:, py + 1], rows[:, py + 2]
        prods = []
        for px in range(mx_ + bs - 1):
            j = 2 + px
            dx = (a[:, j + 2] + 2.0 * b[:, j + 2] + c[:, j + 2] - a[:, j]
                  - 2.0 * b[:, j] - c[:, j])
            dy = (c[:, j] + 2.0 * c[:, j + 1] + c[:, j + 2] - a[:, j]
                  - 2.0 * a[:, j + 1] - a[:, j + 2])
            prods.append({"xx": dx * dx, "yy": dy * dy, "xy": dx * dy})
        for my in range(my_):
            if not 0 <= py - my < bs:
                continue
            for mx in range(mx_):
                for bx in range(bs):
                    for q in s:
                        s[q][my][mx] = s[q][my][mx] + prods[mx + bx][q]
    out = torch.empty((len(origins), my_, mx_))
    for my in range(my_):
        for mx in range(mx_):
            sxx, syy, sxy = (s[q][my][mx] for q in ("xx", "yy", "xy"))
            det = sxx * syy - sxy * sxy
            tr = sxx + syy
            out[:, my, mx] = det - k * tr * tr
    return out


def _harris_walk(src, bs, tile, vec, from_rgb=False, k=0.04, csa=None):
    """``harris_tile_kernel<bs, from_rgb, csa>``: block (bx, by) copies
    tile (by, bx)'s source; K4 converts it to gray; each thread computes
    and stores its micro-tiles.  Returns the output and how often each pixel
    was written."""
    C = 3 if from_rgb else 1
    H, W = src.shape[:2]
    flat = src.reshape(H, W * C)
    th, tw = tile
    my_, mx_ = hk.MICRO_TILE
    GH, GP = th + bs + 1, tw + 2 * hk.PAD_X
    mxn = tw // mx_
    ty_step = hk.TILE_THREADS // mxn
    origins = [(oy, mx_ * (tid % mxn)) for tid in range(hk.TILE_THREADS)
               for oy in range(my_ * (tid // mxn), th, my_ * ty_step)]
    out = torch.full((H, W), float("nan"))
    writes = torch.zeros((H, W), dtype=torch.int64)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            g, copies = _copy_tile(flat, H, W, C, y0, x0, GH, GP * C, vec)
            assert bool((copies == 1).all())
            if from_rgb:
                g = 0.299 * g[:, 0::3] + 0.587 * g[:, 1::3] + 0.114 * g[:, 2::3]
            resp = _micro_tiles(g, origins, bs, k)
            if csa is not None:
                resp = hk.convert_scale_abs_ref(resp, *csa)
            for (oy, ox), r in zip(origins, resp):
                for my in range(my_):
                    y, x = y0 + oy + my, x0 + ox
                    if y >= H:
                        break
                    n = (mx_ if x < W else 0) if vec else max(0, min(mx_, W - x))
                    out[y, x:x + n] = r[my, :n]
                    writes[y, x:x + n] += 1
    return out, writes


WALK_SHAPES = [(1, 1), (1, 9), (9, 1), (3, 5), (7, 13), (17, 23), (20, 65),
               (20, 66), (20, 67), (24, 68), (33, 130)]


@pytest.mark.parametrize("H,W", WALK_SHAPES)
@pytest.mark.parametrize("block_size", [2, 3])
def test_k2_walk_is_bit_equal_to_plain_version(H, W, block_size):
    gray = hk.cvt_color(_t(_img(H * 100 + W, H, W)))
    want = hk.corner_harris_ref(gray, block_size)
    _close_scaled(want.numpy(), jmh.corner_harris(jnp.asarray(gray.numpy()),
                                                  block_size))
    for tile in ((8, 32), hk.fused_tile(H, W, block_size)):
        got, writes = _harris_walk(gray, block_size, tile, vec=W % 4 == 0)
        assert bool((writes == 1).all())
        assert torch.equal(got, want)


@pytest.mark.parametrize("H,W,tile", [(17, 23, (16, 32)), (20, 66, (8, 32)),
                                      (24, 68, (16, 64))])
@pytest.mark.parametrize("block_size", [2, 3])
@pytest.mark.parametrize("with_csa", [False, True])
def test_k4_walk_is_bit_equal_to_plain_version(H, W, tile, block_size,
                                               with_csa):
    img = _t(_img(H + 7 * W, H, W))
    want = hk.harris_fused_ref(img, block_size, alpha=1e-6, beta=3.0,
                               with_csa=with_csa)
    got, writes = _harris_walk(img, block_size, tile, vec=W % 4 == 0,
                               from_rgb=True,
                               csa=(1e-6, 3.0) if with_csa else None)
    assert bool((writes == 1).all())
    assert torch.equal(got, want)


def test_tile_geometry_fits_and_covers_every_candidate():
    my, mx = hk.MICRO_TILE
    for (th, tw), bs in ((t, bs) for t in hk.TILE_CANDIDATES for bs in (2, 3)):
        assert hk.tile_ok(th, tw)
        feasible = hk.tile_score((th, tw), 1080, 1920, bs) < float("inf")
        assert feasible == (hk.tile_smem_bytes(th, tw, bs, from_rgb=True)
                            <= SMEM_BYTES)
        assert hk.tile_smem_bytes(th, tw, bs) < hk.tile_smem_bytes(
            th, tw, bs, from_rgb=True)
        # the threads' micro-tiles cover the tile once each
        mxn = tw // mx
        cells = [(oy, mx * (tid % mxn)) for tid in range(hk.TILE_THREADS)
                 for oy in range(my * (tid // mxn), th,
                                 my * (hk.TILE_THREADS // mxn))]
        assert sorted(cells) == [(oy, ox) for oy in range(0, th, my)
                                 for ox in range(0, tw, mx)]
    assert not hk.tile_ok(9, 32) and not hk.tile_ok(16, 30)
    assert not hk.tile_ok(16, 24)                # 6 columns: 128 % 6 != 0
    assert not hk.tile_ok(16, 4 * hk.TILE_THREADS * 2)


def _k3_walk(n, offset, out_aligned, grid, alpha, beta, x):
    """``repro_convert_scale_abs_f32``: float4 loads and stores when both
    pointers are 16-byte aligned (the n % 4 tail to block 0), floats
    otherwise; a grid-stride walk, CSA_UNROLL loads a thread before use.
    ``offset`` is x's address modulo 16 in bytes."""
    unroll, threads = 4, 256
    vec = offset == 0 and out_aligned
    width = 4 if vec else 1
    nv = n // width
    out = torch.full((n,), float("nan"))
    writes = torch.zeros((n,), dtype=torch.int64)
    for b in range(grid):
        for t in range(threads):
            i0 = b * threads * unroll + t
            while i0 < nv:
                for j in range(unroll):
                    i = i0 + j * threads
                    if i < nv:
                        sl = slice(width * i, width * i + width)
                        out[sl] = hk.convert_scale_abs_ref(x[sl], alpha, beta)
                        writes[sl] += 1
                i0 += grid * threads * unroll
        if b == 0:
            for t in range(n - width * nv):
                out[width * nv + t] = hk.convert_scale_abs_ref(
                    x[width * nv + t:width * nv + t + 1], alpha, beta)[0]
                writes[width * nv + t] += 1
    return out, writes


@pytest.mark.parametrize("n", [1, 3, 4096, 4097, 4098, 4099])
@pytest.mark.parametrize("offset", [0, 4])
def test_k3_walk_writes_every_element_once(n, offset):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)
                         .astype(np.float32) * 300)
    x[: min(n, 3)] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf")])[: min(n, 3)]
    want = hk.convert_scale_abs_ref(x, -2.0, 100.0)
    for grid in (1, 2):
        got, writes = _k3_walk(n, offset, True, grid, -2.0, 100.0, x)
        assert bool((writes == 1).all())
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
