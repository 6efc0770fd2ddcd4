"""K7, the port's flash-attention forward, on the CPU, held against the JAX
package.

The JAX ``flash_attention`` Pallas kernel cannot run here: the installed
``jax.experimental.pallas`` has no ``load`` (``flash_attention.py:52``).  So
the oracle is the JAX package's own software function,
``repro.kernels.ref.reference_attention``, for o, plus a jnp logsumexp of
the same masked scores for lse.  On the CPU the port's wrapper
(``flash_attention_fwd`` and ``kernels.ops.attention``) takes its plain
version, ``flash_attention_ref``; the CUDA kernel itself is held to that
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Shapes, masks and dtypes are those of ``tests/test_kernels.py:16-24``, plus
ragged T and M (off any tile); tolerances are that file's, 2e-5 in f32 and
2.5e-2 in bf16, for o, and 2e-5 for the f32 lse.

The bf16 kernel's arithmetic (tensor-core products, the online softmax in
the log2 domain, p carried into P.V as two bf16 terms) is emulated here in
plain torch, in its order of operations, and held to the plain version
with ``chip_smoke.flash_err``'s element-wise bf16 limit.  The f32 SIMT
kernel's blocks and key tiles (its online softmax in the log2 domain, the
rescale, the rows that see no key) are emulated too, and held to the JAX
reference with the f32 limits.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(1)

SHAPES = [(1, 128, 1, 64, 128), (2, 256, 4, 64, 256), (1, 512, 2, 128, 512),
          (2, 128, 4, 32, 384)]
RAGGED = [(2, 77, 3, 16, 131), (1, 100, 2, 32, 45), (1, 33, 2, 256, 33)]
MASKS = [(True, 0), (True, 64), (False, 0)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.5e-2)}


def _inputs(B, T, H, hd, M, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, T, H, hd), (B, M, H, hd), (B, M, H, hd))]


def _jax_oracle(q, k, v, causal, window):
    """(o, lse [B*H, T]) of the JAX package's reference."""
    o = ref.reference_attention(q, k, v, causal, window)
    B, T, H, hd = q.shape
    M = k.shape[1]
    s = jnp.einsum("bthd,bmhd->bhtm", q.astype(jnp.float32),
                   k.astype(jnp.float32)) / np.sqrt(hd)
    d = jnp.arange(T)[:, None] - jnp.arange(M)[None, :]
    mask = jnp.ones((T, M), bool)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    s = jnp.where(mask[None, None], s, -1e30)
    lse = jnp.log(jnp.sum(jnp.exp(s - s.max(-1, keepdims=True)), -1)) \
        + s.max(-1)
    return np.asarray(o, np.float32), np.asarray(lse).reshape(B * H, T)


@pytest.mark.parametrize("shape", SHAPES + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_the_jax_reference(shape, causal, window,
                                                 dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(*shape, seed=sum(shape))
    want_o, want_lse = _jax_oracle(*(jnp.asarray(a, jdt) for a in arrs),
                                   causal, window)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    assert o.dtype == tdt and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (shape[0] * shape[2],
                                                        shape[1])
    np.testing.assert_allclose(o.float().numpy(), want_o, rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)
    # the public entry and the Off-load Switcher's op: same function
    torch.testing.assert_close(fa.flash_attention(q, k, v, causal, window), o,
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.attention(q, k, v, causal, window), o,
                               rtol=0, atol=0)
    assert fa.LAUNCHES == {"flash_attention": 0,     # CPU: no kernel launched
                           "flash_attention_bwd_dq": 0,
                           "flash_attention_bwd_dkv": 0}


def test_rows_that_see_no_key_get_the_references_uniform_softmax():
    """T > M + window - 1: the last rows are masked everywhere, and the
    reference's -1e30 fill gives them the mean of v (lse -1e30 + log M)."""
    arrs = _inputs(1, 40, 2, 16, 10, seed=3)
    want_o, want_lse = _jax_oracle(*(jnp.asarray(a) for a in arrs), True, 4)
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in arrs),
                                    True, 4)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o.numpy()[0, 39], arrs[2][0].mean(0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5)


def test_the_kernel_takes_the_head_dims_of_every_config():
    from repro_torch.configs import all_configs

    hds = {c.hd for c in all_configs().values()} \
        | {c.reduced().hd for c in all_configs().values()}
    assert hds <= set(fa.HEAD_DIMS)


def test_a_tensor_on_another_device_is_refused():
    q = torch.zeros((1, 4, 1, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(q, q, q)


# --------------------------------------------------------------------------- #
# the bf16 tensor-core kernel's arithmetic, emulated on the CPU
# --------------------------------------------------------------------------- #
# chip_smoke.py's K7 cases: ragged (B, T, H, M) and (causal, window) masks;
# (1, 300, 2, 200) under window 40 (non-causal) or 64 (causal) has rows that
# see no key
FA_RAGGED = [(2, 77, 3, 131), (1, 300, 2, 200)]
FA_MASKS = [(True, 0), (True, 64), (False, 0), (False, 40)]
BK_TC = 64                                 # keys a tile of the kernel
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _fmaf(a, b, c):
    """fmaf(a, b, c) on f32 tensors: the f32 product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _emulate_tensor_core_kernel(q, k, v, causal, window, two_terms=True):
    """``flash_fwd_wgmma_kernel`` step by step: bf16 q . k summed in f32 and
    scaled by scale*log2(e) (one f32 constant), per tile of 64 keys the
    running max m and sum l (of the f32 p's) in the log2 domain, p =
    exp2(fmaf(s, scale*log2e, -m)) for a visible key, exp2(-1e30*log2e -
    m) for a masked one, 0 beyond M; o rescaled by exp2(m_old - m_new) and
    += bf16(p) . v + bf16(p - bf16(p)) . v (f32 sums); o = acc / max(l,
    1e-30) in bf16 and lse = (m + log2 l) * ln 2.  Every row of a tile
    sees every key tile here: a tile the kernel skips adds exactly 0.  The
    kernel's ex2.approx (within 2^-22 of exp2) and its order of the f32
    sums inside a product are not emulated."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    sl2 = torch.tensor(np.float32(1.0 / math.sqrt(hd)) * LOG2E)
    neg = torch.tensor(np.float32(-1e30) * LOG2E)
    vis = fa.visible(T, M, causal, window)
    m = torch.full((B, H, T, 1), float(neg))
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, hd))
    for k0 in range(0, M, BK_TC):
        k1 = min(M, k0 + BK_TC)
        seen = vis[:, k0:k1]
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)
        m_new = torch.maximum(m, torch.where(seen, s * sl2, neg)
                              .amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(seen, torch.exp2(_fmaf(s, sl2, -m_new)),
                        torch.exp2(neg - m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        acc = acc * alpha + hi @ vf[:, :, k0:k1]
        if two_terms:
            acc = acc + (p - hi).bfloat16().float() @ vf[:, :, k0:k1]
        m = m_new
    o = (acc / l.clamp(min=1e-30)).permute(0, 2, 1, 3).to(q.dtype)
    lse = ((m + torch.log2(l)) * LN2).reshape(B * H, T)
    return o, lse


def _share_of_bf16_limit(o, lse, q, k, v, causal, window):
    """``chip_smoke.flash_err``'s bf16 checks against the plain version:
    the largest |o - o_ref| / (2^-7 |o_ref| + 2^-8 rms(o_ref)) element by
    element, and the largest |lse - lse_ref| / max(1, |lse_ref|)."""
    ro, rlse = fa.flash_attention_ref(q, k, v, causal, window)
    ro = ro.float()
    rms = ro.square().mean().sqrt()
    limit = 2.0**-7 * ro.abs() + 2.0**-8 * rms
    worst = ((o.float() - ro).abs() / limit).max().item()
    dl = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    return worst, dl


TC_CASES = [(shape, causal, window, hd) for shape in FA_RAGGED
            for causal, window in FA_MASKS for hd in fa.HEAD_DIMS]
TC_CASES.append(((1, 2048, 2, 2048), True, 0, 256))


@pytest.mark.parametrize("shape,causal,window,hd", TC_CASES,
                         ids=lambda x: ("x".join(map(str, x))
                                        if isinstance(x, tuple) else str(x)))
def test_tensor_core_arithmetic_meets_the_element_wise_bf16_limit(
        shape, causal, window, hd):
    B, T, H, M = shape
    rng = np.random.default_rng(T + M + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, hd),
                                                    dtype=np.float32)
                                ).bfloat16() for L in (T, M, M))
    o, lse = _emulate_tensor_core_kernel(q, k, v, causal, window)
    worst, dl = _share_of_bf16_limit(o, lse, q, k, v, causal, window)
    assert worst <= 1.0 and dl <= 1e-5, (worst, dl)


# --------------------------------------------------------------------------- #
# the f32 SIMT kernel's blocks and tiles, emulated on the CPU
# --------------------------------------------------------------------------- #
def _key_range(qa, qb, M, causal, window):
    """``key_range`` of ``csrc/flash_attention.cu``: the keys [lo, hi) that
    query rows [qa, qb] visit; every key when one of them sees none."""
    hi = min(M, qb + 1) if causal else M
    lo = max(0, qa - window + 1) if window > 0 and qb < M + window - 1 else 0
    return lo, hi


def _emulate_simt_fwd(q, k, v, causal, window):
    """``flash_fwd_kernel`` block by block and tile by tile, in f32: a block
    owns ``fa.SIMT_FWD_ROWS`` query rows, k and v stream in tiles of
    ``fa.simt_fwd_tile(hd)`` keys from the block's first visible key
    (``_key_range``).  Per tile, in the log2 domain: the row's max m over
    its visible scores s * scale*log2e (one f32 constant), p =
    exp2(fmaf(s, scale*log2e, -m_new)) for a visible key, exp2(-1e30*log2e
    - m_new) for a masked one inside the span (weight 1 while the row has
    seen nothing, else 0); l and o rescaled by exp2(m - m_new) where the max
    moved, then l += sum p, o += p v.  o = acc / max(l, 1e-30), lse = (m +
    log2 l) ln 2.  Returns (o, lse [B*H, T], stats): the blocks launched,
    the most key tiles a block takes and the rescales of a row that had
    seen a visible key.  The order of the sums inside a tile's products is
    not emulated."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    br, bn = fa.SIMT_FWD_ROWS, fa.simt_fwd_tile(hd)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    sl2 = torch.tensor(np.float32(1.0 / math.sqrt(hd)) * LOG2E)
    neg = torch.tensor(np.float32(-1e30) * LOG2E)
    vis = fa.visible(T, M, causal, window)
    o, lse = torch.zeros_like(qf), torch.zeros((B, H, T))
    stats = {"blocks": B * H * -(-T // br), "most": 0, "rescaled": 0}
    for q0 in range(0, T, br):
        q1 = min(q0 + br, T)
        lo, hi = _key_range(q0, q1 - 1, M, causal, window)
        m = torch.full((B, H, q1 - q0, 1), float(neg))
        l = torch.zeros((B, H, q1 - q0, 1))
        acc = torch.zeros((B, H, q1 - q0, hd))
        tiles = range(lo, hi, bn)
        stats["most"] = max(stats["most"], len(tiles))
        for t0 in tiles:
            t1 = min(t0 + bn, hi)
            seen = vis[q0:q1, t0:t1]
            s = qf[:, :, q0:q1] @ kf[:, :, t0:t1].transpose(-1, -2)
            m_new = torch.maximum(m, torch.where(seen, s * sl2, neg)
                                  .amax(-1, keepdim=True))
            p = torch.where(seen, torch.exp2(_fmaf(s, sl2, -m_new)),
                            torch.exp2(neg - m_new))
            moved = m_new != m
            stats["rescaled"] += int((moved & (m > neg)).sum())
            alpha = torch.exp2(m - m_new)
            l = torch.where(moved, l * alpha, l) + p.sum(-1, keepdim=True)
            acc = (torch.where(moved, acc * alpha, acc)
                   + p @ vf[:, :, t0:t1])
            m = m_new
        den = l.clamp(min=1e-30)
        o[:, :, q0:q1] = acc / den
        lse[:, :, q0:q1] = ((m + torch.log2(den)) * LN2)[..., 0]
    return o.permute(0, 2, 1, 3), lse.reshape(B * H, T), stats


# the driver run's attention ([8, 64, 10, 64] as (B, T, H, M)) at every
# head_dim, under causal masks with and without a window and no mask; T =
# 300, M = 200 under window 40, where rows 239.. see no key; T = M = 256 at
# hd 64, where a block takes up to four key tiles and the rescale runs
SIMT_MASKS = [(True, 0), (True, 32), (True, 64), (False, 0)]
SIMT_CASES = ([((8, 64, 10, 64), causal, window, hd) for hd in fa.HEAD_DIMS
               for causal, window in SIMT_MASKS]
              + [((1, 300, 2, 200), causal, 40, hd) for hd in fa.HEAD_DIMS
                 for causal in (True, False)]
              + [((1, 256, 2, 256), causal, window, 64)
                 for causal, window in SIMT_MASKS])


@pytest.mark.parametrize("shape,causal,window,hd", SIMT_CASES,
                         ids=lambda x: ("x".join(map(str, x))
                                        if isinstance(x, tuple) else str(x)))
def test_simt_forward_tiles_meet_the_f32_limits(shape, causal, window, hd):
    B, T, H, M = shape
    arrs = _inputs(B, T, H, hd, M, seed=T + M + hd + window)
    want_o, want_lse = _jax_oracle(*(jnp.asarray(a) for a in arrs), causal,
                                   window)
    o, lse, stats = _emulate_simt_fwd(*(torch.from_numpy(a) for a in arrs),
                                      causal, window)
    diff = np.abs(o.numpy() - want_o)
    rms = np.sqrt(np.mean(np.square(want_o)))
    assert diff.max() <= 2e-5 * np.abs(want_o).max()
    assert (diff <= 2e-5 * (np.abs(want_o) + rms)).all(), \
        float(np.max(diff / (2e-5 * (np.abs(want_o) + rms))))
    assert (np.abs(lse.numpy() - want_lse)
            <= 1e-5 * np.maximum(1.0, np.abs(want_lse))).all()
    if T == 300:                           # its last rows see no key
        np.testing.assert_allclose(o.numpy()[:, -1], arrs[2].mean(1),
                                   rtol=1e-5, atol=1e-5)
    if T == 256 and window == 0:           # several tiles: the max moves
        assert stats["most"] == 256 // fa.simt_fwd_tile(hd)
        assert stats["rescaled"] > 0


def test_simt_forward_geometry_fills_the_card_at_the_drivers_shape():
    """Every head_dim's block fits the 227 KB a block may take; the driver
    run's [8, 64, 10, 64] makes 320 blocks of one key tile each under both
    of its masks (so the ring has one stage and no row is rescaled)."""
    for hd in fa.HEAD_DIMS:
        assert fa.simt_fwd_smem_bytes(hd, 1) < fa.simt_fwd_smem_bytes(hd)
        assert fa.simt_fwd_smem_bytes(hd) <= 232_448
    arrs = [torch.from_numpy(a) for a in _inputs(8, 64, 10, 64, 64, seed=1)]
    for window in (32, 0):
        *_, stats = _emulate_simt_fwd(*arrs, True, window)
        assert stats == {"blocks": 320, "most": 1, "rescaled": 0}
