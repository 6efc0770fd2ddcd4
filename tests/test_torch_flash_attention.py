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
with ``chip_smoke.flash_err``'s element-wise bf16 limit.
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
