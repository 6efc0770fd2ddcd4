"""K8 and K9, the port's flash-attention backward, on the CPU, held against
the JAX package.

The JAX Pallas kernels cannot run here (the installed
``jax.experimental.pallas`` has no ``load``), so the oracle is ``jax.grad``
through the JAX package's software function,
``repro.kernels.ref.reference_attention``.  On the CPU the port's wrapper
(``flash_attention_bwd``) takes its plain version,
``flash_attention_bwd_ref``, and ``FlashAttention`` (the autograd Function
behind ``kernels.ops.attention``) runs the plain forward and backward; the
CUDA kernels are held to those plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Cases: ``tests/test_kernels.py:39-66``'s (2, 256, 2, 64) causal and
(1, 256, 2, 64) with window 128, plus T != M and lengths off any tile, and
rows that see no key (T > M + window - 1), whose stored lse cannot give
their probabilities.  The limit is f32's 2e-4, relative to the gradient's
largest value.

The bf16 kernels' arithmetic (tensor-core products with bf16 operands and
f32 sums, p from K7's lse in the log2 domain, delta from the f32 p * dp,
p and ds carried into their products as two bf16 terms) is emulated here
in plain torch, in their order of operations, and held to the plain
backward with ``chip_smoke.grad_err``'s element-wise bf16 limit.

The f32 SIMT kernels' tiles (16-row blocks, the other side streamed tile
by tile, K8's one or two sweeps, K9's rows that see no key) are emulated
the same way and held to ``jax.grad`` of the reference with the
element-wise f32 limit, 2e-4 (|g| + rms), at the fault-tolerant driver's
[8, 64, 10, 64] and over ``CASES``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from test_torch_flash_attention import (FA_MASKS, FA_RAGGED, LOG2E, _fmaf,
                                        _emulate_tensor_core_kernel)

torch.set_num_threads(1)

# (B, T, H, hd, M, causal, window)
CASES = [(2, 256, 2, 64, 256, True, 0),
         (1, 256, 2, 64, 256, True, 128),
         (2, 77, 3, 16, 131, True, 0),
         (1, 100, 2, 32, 45, False, 0),
         (2, 70, 2, 16, 50, False, 24),
         (1, 90, 2, 32, 40, True, 16)]        # rows 55.. see no key
TOL = 2e-4


def _inputs(B, T, H, hd, M, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, T, H, hd), (B, M, H, hd), (B, M, H, hd),
                      (B, T, H, hd))]


def _jax_grads(q, k, v, do, causal, window):
    """(dq, dk, dv) of sum(reference_attention(q, k, v) * do)."""
    def f(q, k, v):
        return jnp.sum(ref.reference_attention(q, k, v, causal, window) * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _close(got, want, name):
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= TOL, f"{name}: {err} of max |ref|"


def _ids(c):
    return "B{}T{}H{}hd{}M{}-c{}w{}".format(*c)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_grad_of_the_reference(case):
    B, T, H, hd, M, causal, window = case
    q, k, v, do = _inputs(B, T, H, hd, M, seed=sum(case[:5]))
    want = _jax_grads(*map(jnp.asarray, (q, k, v, do)), causal, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal, window)
    fa.reset_launches()
    got = fa.flash_attention_bwd(tq, tk, tv, lse, tdo, causal, window)
    assert all(fa.LAUNCHES[k] == 0 for k in fa.LAUNCHES)   # CPU: plain
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_function_gradients_match_jax_grad_of_the_reference(case):
    B, T, H, hd, M, causal, window = case
    q, k, v, do = _inputs(B, T, H, hd, M, seed=7 + sum(case[:5]))
    want = _jax_grads(*map(jnp.asarray, (q, k, v, do)), causal, window)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.attention(*leaves, causal, window)
    want_o = ref.reference_attention(*map(jnp.asarray, (q, k, v)), causal,
                                     window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g.numpy(), w, name)


def test_rows_that_see_no_key_send_do_over_m_to_every_dv_row():
    """The trap of the stored lse: such a row's p is 1/M, not 1."""
    B, T, H, hd, M, window = 1, 12, 1, 16, 4, 2       # rows 5.. see no key
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(B, T, H, hd, M, seed=3))
    blind = ~fa.visible(T, M, True, window).any(dim=1)
    assert blind.tolist() == [False] * 5 + [True] * 7
    do = do * blind[None, :, None, None]      # only the blind rows' gradient
    o, lse = fa.flash_attention_fwd(q, k, v, True, window)
    assert bool((lse[0, 5:] <= -1e29).all())  # lse says nothing of M
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, lse, do, True, window)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    want = do.sum(dim=1, keepdim=True) / M
    torch.testing.assert_close(dv, want.expand_as(dv), rtol=1e-6, atol=1e-6)


def test_bf16_gradients_on_the_cpu_stay_in_bf16():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in
                   _inputs(1, 33, 2, 32, 33, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.attention(*leaves, True, 8)
    got = torch.autograd.grad(o, leaves, do)
    want = _jax_grads(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                        for t in (q, k, v, do)), True, 8)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=2.5e-2,
                                   atol=2.5e-2 * np.abs(w).max())


def test_k8_and_k9_plain_parts_make_the_whole_backward():
    """On the CPU the K8 wrapper gives (dq, delta) and the K9 wrapper
    (dk, dv) from that delta: together, the plain backward.  delta is
    rowsum(o * do) of the forward's o, and 0 on rows 37.. that see no key
    (their ds is 0 whatever delta is)."""
    B, T, H, hd, M = 2, 40, 2, 16, 30
    q, k, v, do = map(torch.from_numpy, _inputs(B, T, H, hd, M, seed=11))
    o, lse = fa.flash_attention_fwd(q, k, v, True, 8)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, lse, do, True, 8)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True, 8)
    assert delta.shape == (B * H, T) and delta.dtype == torch.float32
    want = (o * do).sum(-1).permute(0, 2, 1).reshape(B * H, T)
    torch.testing.assert_close(delta[:, :37], want[:, :37], rtol=1e-5,
                               atol=1e-5)
    assert float(delta[:, 37:].abs().max()) == 0.0
    for got, want in zip((dq, dk, dv), fa.flash_attention_bwd_ref(
            q, k, v, lse, do, True, 8)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_backward_launch_checks_refuse_what_the_kernels_do_not_take():
    q, k, v, do = map(torch.from_numpy, _inputs(1, 8, 2, 16, 6, seed=1))
    lse = torch.zeros((2, 8))
    assert fa._check_bwd(q, k, v, {"do": do},
                         {"lse": lse}) == (1, 8, 6, 2, 16)
    with pytest.raises(ValueError, match=r"do of \[1, 8, 2, 16\]"):
        fa._check_bwd(q, k, v, {"do": do[:, :5].contiguous()}, {"lse": lse})
    with pytest.raises(ValueError, match="f32 delta"):
        fa._check_bwd(q, k, v, {"do": do}, {"lse": lse,
                                            "delta": lse[:1].contiguous()})
    with pytest.raises(ValueError, match="head_dim 8"):
        x = torch.zeros((1, 8, 2, 8))
        fa._check_bwd(x, x[:, :6].contiguous(), x[:, :6].contiguous(),
                      {"do": x}, {"lse": lse})
    with pytest.raises(TypeError, match="bfloat16"):
        fa._check_bwd(q, k, v, {"do": do.bfloat16()}, {"lse": lse})


# --------------------------------------------------------------------------- #
# the bf16 tensor-core kernels' arithmetic, emulated on the CPU
# --------------------------------------------------------------------------- #
def _bf16_terms(x, terms: int):
    """x as the kernels feed it to a product: hi = bf16(x), plus lo =
    bf16(x - hi) when ``terms`` is 2."""
    hi = x.bfloat16().float()
    return hi if terms == 1 else hi + (x - hi).bfloat16().float()


def _emulate_tensor_core_bwd(q, k, v, do, lse, causal, window, terms=(2, 2)):
    """``flash_bwd_dq_wgmma_kernel`` and ``flash_bwd_dkv_wgmma_kernel`` step
    by step: s = q . k and dp = do . v with bf16 operands and f32 sums; p =
    exp2(fmaf(s, scale*log2e, -lse*log2e)) on visible pairs (K7's lse read
    in the log2 domain it was written in; both factors are f32 constants),
    0 elsewhere; K8's first sweep sums delta = rowsum(p * dp) of those f32
    values; ds = p * (dp - delta); dq = (dS K) * scale, dk = (dS^T Q) *
    scale, dv = P^T dO with f32 sums, P (p, and 1/M on the rows that see no
    key, found by their position) as ``terms[0]`` bf16 terms and dS as
    ``terms[1]``; dq, dk, dv rounded to bf16.  Whole [T, M] products stand
    in for the kernels' tiles: a tile they skip or a pair they mask adds
    exactly 0.  The SFU's ex2.approx (within 2^-22 of exp2) and the order
    of the f32 sums are not emulated."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    qf, kf, vf, dof = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, do))
    scale = torch.tensor(np.float32(1.0 / np.sqrt(hd)))
    sl2 = scale * torch.tensor(LOG2E)
    lse2 = (lse * torch.tensor(LOG2E)).reshape(B, H, T, 1)
    vis = fa.visible(T, M, causal, window)
    blind = ~vis.any(dim=1, keepdim=True)                 # [T, 1]
    zero = torch.zeros(())
    p = torch.where(vis, torch.exp2(_fmaf(qf @ kf.transpose(-1, -2), sl2,
                                          -lse2)), zero)
    dp = dof @ vf.transpose(-1, -2)
    delta = (p * dp).sum(-1, keepdim=True)                # K8's first sweep
    ds = _bf16_terms(torch.where(vis, p * (dp - delta), zero), terms[1])
    pv = torch.where(blind, torch.tensor(np.float32(1.0) / np.float32(M)), p)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = _bf16_terms(pv, terms[0]).transpose(-1, -2) @ dof
    return [x.permute(0, 2, 1, 3).bfloat16() for x in (dq, dk, dv)]


def _grad_share_of_bf16_limit(got, want):
    """``chip_smoke.grad_err``'s bf16 check: the largest |g - g_ref| /
    (2^-7 |g_ref| + 2^-8 rms(g_ref)), element by element."""
    want = want.float()
    rms = want.square().mean().sqrt()
    limit = 2.0**-7 * want.abs() + 2.0**-8 * rms
    return ((got.float() - want).abs() / limit).max().item()


def _tc_case(shape, causal, window, hd, terms=(2, 2)):
    """Shares of the limit of the emulated (dq, dk, dv) against the plain
    backward from the same (K7's emulated) lse."""
    B, T, H, M = shape
    rng = np.random.default_rng(T + M + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, L, H, hd),
                                                        dtype=np.float32)
                                    ).bfloat16() for L in (T, M, M, T))
    _, lse = _emulate_tensor_core_kernel(q, k, v, causal, window)
    got = _emulate_tensor_core_bwd(q, k, v, do, lse, causal, window, terms)
    want = fa.flash_attention_bwd_ref(q, k, v, lse, do, causal, window)
    return [_grad_share_of_bf16_limit(g, w) for g, w in zip(got, want)]


# chip_smoke.py's K8/K9 cases at every head_dim (rows that see no key under
# window 40 at T = 300, M = 200), plus a long causal row
BWD_TC_CASES = [(shape, causal, window, hd) for shape in FA_RAGGED
                for causal, window in FA_MASKS for hd in fa.HEAD_DIMS]
BWD_TC_CASES.append(((1, 2048, 2, 2048), True, 0, 256))


@pytest.mark.parametrize("shape,causal,window,hd", BWD_TC_CASES,
                         ids=lambda x: ("x".join(map(str, x))
                                        if isinstance(x, tuple) else str(x)))
def test_tensor_core_backward_arithmetic_meets_the_element_wise_bf16_limit(
        shape, causal, window, hd):
    shares = _tc_case(shape, causal, window, hd)
    assert max(shares) <= 1.0, shares


def test_one_bf16_term_of_p_or_ds_misses_the_element_wise_limit():
    """Why the kernels carry p and ds as two bf16 terms: with one, the
    rounding of ds (2^-9 of it) moves dq and dk, and that of p moves dv,
    past one bf16 ulp of the reference's gradient on a long causal row."""
    case = ((1, 2048, 2, 2048), True, 0, 256)
    one_ds = _tc_case(*case, terms=(2, 1))
    one_p = _tc_case(*case, terms=(1, 2))
    assert one_ds[0] > 1.0 and one_ds[1] > 1.0 and one_ds[2] <= 1.0, one_ds
    assert one_p[2] > 1.0 and max(one_p[:2]) <= 1.0, one_p


# --------------------------------------------------------------------------- #
# the f32 SIMT kernels' tiles, emulated on the CPU
# --------------------------------------------------------------------------- #
def _emulate_simt_bwd(q, k, v, do, lse, causal, window):
    """``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` block by block
    and tile by tile, in f32: a block owns ``fa.SIMT_BWD_ROWS`` rows, the
    other side streams in tiles of ``fa.simt_bwd_tile(hd)`` rows from the
    block's first visible row.  K8 sweeps its keys twice when they take
    more than one tile (delta = rowsum(p * dp) summed tile by tile, then ds
    = p (dp - delta) and dq += dS K), once when they fit one; K9 adds the
    tiles of the queries that see its keys (dv += P^T dO, dk += dS^T Q),
    then those of the rows that see no key (dv += dO / M).  Returns (dq,
    dk, dv, delta [B*H, T], K8's most key tiles a block).  The order of the
    sums inside a tile's products is not emulated."""
    B, T, H, hd = q.shape
    M = k.shape[1]
    br, bn = fa.SIMT_BWD_ROWS, fa.simt_bwd_tile(hd)
    qf, kf, vf, dof = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, do))
    lse = lse.reshape(B, H, T, 1)
    scale = torch.tensor(np.float32(1.0 / np.sqrt(hd)))

    def tile(r0, r1, t0, t1):
        """(p, dp) of query rows [r0, r1) against keys [t0, t1)."""
        s = qf[:, :, r0:r1] @ kf[:, :, t0:t1].transpose(-1, -2)
        vis = fa.visible(T, M, causal, window)[r0:r1, t0:t1]
        p = torch.where(vis, torch.exp(s * scale - lse[:, :, r0:r1]),
                        torch.zeros(()))
        return p, dof[:, :, r0:r1] @ vf[:, :, t0:t1].transpose(-1, -2)

    dq, delta = torch.zeros_like(qf), torch.zeros((B, H, T))
    most = 0
    for q0 in range(0, T, br):
        q1 = min(q0 + br, T)
        hi = min(M, q1) if causal else M
        lo = max(0, q0 - window + 1) if window > 0 else 0
        tiles = [(t0, min(t0 + bn, hi)) for t0 in range(lo, hi, bn)]
        most = max(most, len(tiles))
        part = torch.zeros((B, H, q1 - q0))
        kept = []                              # one tile: no second sweep
        for t0, t1 in tiles:
            p, dp = tile(q0, q1, t0, t1)
            part = part + (p * dp).sum(-1)
            kept.append((p, dp))
        delta[:, :, q0:q1] = part
        acc = torch.zeros((B, H, q1 - q0, hd))
        for t0, t1 in tiles:
            p, dp = kept[0] if len(tiles) == 1 else tile(q0, q1, t0, t1)
            acc = acc + (p * (dp - part[..., None])) @ kf[:, :, t0:t1]
        dq[:, :, q0:q1] = acc * scale

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    blind = min(T, M + window - 1) if window > 0 else T
    inv_m = torch.tensor(np.float32(1.0) / np.float32(M))
    for k0 in range(0, M, br):
        k1 = min(k0 + br, M)
        lo = k0 if causal else 0
        hi = min(min(T, k1 - 1 + window) if window > 0 else T, blind)
        dka = torch.zeros((B, H, k1 - k0, hd))
        dva = torch.zeros((B, H, k1 - k0, hd))
        for t0 in range(lo, hi, bn):
            t1 = min(t0 + bn, hi)
            p, dp = tile(t0, t1, k0, k1)
            ds = p * (dp - delta[:, :, t0:t1, None])
            dva = dva + p.transpose(-1, -2) @ dof[:, :, t0:t1]
            dka = dka + ds.transpose(-1, -2) @ qf[:, :, t0:t1]
        for t0 in range(blind, T, bn):
            t1 = min(t0 + bn, T)
            dva = dva + inv_m * dof[:, :, t0:t1].sum(2, keepdim=True)
        dk[:, :, k0:k1] = dka * scale
        dv[:, :, k0:k1] = dva
    grads = [x.permute(0, 2, 1, 3) for x in (dq, dk, dv)]
    return (*grads, delta.reshape(B * H, T), most)


def _share_of_f32_limit(got, want):
    """``chip_smoke.grad_err``'s f32 check: the largest |g - g_ref| /
    (2e-4 (|g_ref| + rms(g_ref))), element by element."""
    rms = np.sqrt(np.mean(np.square(want)))
    return float(np.max(np.abs(got - want) / (2e-4 * (np.abs(want) + rms))))


# the driver run's attention ([8, 64, 10, 64], chip_smoke.driver_attention)
# under both of its masks, then CASES
SIMT_CASES = [(8, 64, 10, 64, 64, True, 32), (8, 64, 10, 64, 64, True, 0),
              *CASES]


@pytest.mark.parametrize("case", SIMT_CASES, ids=_ids)
def test_simt_backward_tiles_meet_the_element_wise_f32_limit(case):
    B, T, H, hd, M, causal, window = case
    q, k, v, do = _inputs(B, T, H, hd, M, seed=3 + sum(case[:5]))
    want = _jax_grads(*map(jnp.asarray, (q, k, v, do)), causal, window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    _, lse = fa.flash_attention_fwd(tq, tk, tv, causal, window)
    *got, delta, most = _emulate_simt_bwd(tq, tk, tv, tdo, lse, causal,
                                          window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        share = _share_of_f32_limit(g.numpy(), w)
        assert share <= 1.0, f"{name}: {share} of the f32 limit"
    want_delta = fa.flash_attention_bwd_dq_ref(tq, tk, tv, lse, tdo, causal,
                                               window)[1]
    torch.testing.assert_close(delta, want_delta, rtol=1e-5, atol=1e-5)
    if T == 64:        # the driver's shape: every block's keys fit one tile
        assert most == 1
    if case == CASES[0]:                # causal T = 256: up to 4 tiles
        assert most == 256 // fa.simt_bwd_tile(hd)

