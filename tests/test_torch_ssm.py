"""The port's recurrences on the CPU, held against the JAX package.

* ``chunked_scan`` against the JAX ``chunked_scan`` and a plain loop: ys,
  the carry and the gradient through the chunked remat (T 512, chunk 256
  and 128), the fall-through when the chunk does not divide T, and the
  ``prep`` hook;
* ``_causal_conv`` with and without a carried state;
* ``ssm_apply`` (the selective SSM) in f32 and bf16 at T in {1, 2, 6, 512},
  without a state and with a random one: the output, ``h`` and ``conv``
  (T 2 without a state pins the reference's zero conv tail);
* ``time_mix``, ``channel_mix`` and ``rwkv_block`` in f32 and bf16 at T in
  {1, 5, 512}, with ``last`` None and given: the outputs, ``S_T``,
  ``tm_last`` and ``cm_last``;
* prefill = stepwise (the counterparts of ``tests/test_moe_ssm.py:102`` and
  ``:123``), and ``time_mix``'s gradient with the scan's remat on and off.

Weights and inputs are drawn with numpy from a seed and handed to both
packages; every leaf that the reference initialises to zeros or ones
(``mu``, ``mu_c``, ``u``, ``w_bias``, ``ln_scale``, ``dt_bias``, ``A_log``,
``D``) is drawn at random too, since at their initial values the token
shift, the bonus and the learned decay take no part.  Limits: f32 2e-4,
bf16 2e-2 of max|ref|, a gradient 1e-5 relative (the reference's own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv as JR
import repro.models.ssm as JS
from repro.models.layers import rmsnorm as j_rmsnorm
from repro.models.scan_utils import chunked_scan as j_chunked_scan
from repro_torch.models import rwkv as TR
from repro_torch.models import ssm as TS
from repro_torch.models import scan_utils as TU

torch.set_num_threads(1)

B = 2
D_SSM, N_SSM, K_SSM = 16, 4, 4
D_RWKV, FF_RWKV = 128, 256                    # 2 heads of 64
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SSM_F32 = ("dt_bias", "A_log", "D")
RWKV_F32 = ("mu", "w_bias", "u", "ln_scale", "mu_c")


def _close(got, want, dt, rtol=2e-4):
    """f32: within 2e-4 (relative and absolute); bf16: within 2e-2 of
    max|ref|."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dt == "bf16":
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 2e-2 * scale, (
            np.abs(got - want).max() / scale)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def _both(p: dict, dt: str, f32_leaves) -> tuple[dict, dict]:
    """numpy f32 leaves → (JAX, port) trees; ``f32_leaves`` stay f32."""
    jdt, tdt = DTYPES[dt]
    j = {k: jnp.asarray(v, jnp.float32 if k in f32_leaves else jdt)
         for k, v in p.items()}
    t = {k: torch.from_numpy(v.copy()).to(torch.float32 if k in f32_leaves
                                          else tdt)
         for k, v in p.items()}
    return j, t


def _inp(x: np.ndarray, dt: str):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x.copy()).to(tdt)


def ssm_params(rng, d=D_SSM, N=N_SSM, K=K_SSM) -> dict:
    n = rng.standard_normal
    return {k: v.astype(np.float32) for k, v in {
        "in_proj": n((d, 2, d)) * d ** -0.5,
        "conv": n((K, d)) * K ** -0.5,
        "w_dt": n((d, d)) * d ** -0.5,
        "dt_bias": rng.uniform(-2.0, 0.0, (d,)),
        "w_bc": n((d, 2, N)) * d ** -0.5,
        "A_log": rng.uniform(-1.0, 1.0, (d, N)),
        "D": rng.uniform(0.5, 1.5, (d,)),
        "out_proj": n((d, d)) * d ** -0.5}.items()}


def rwkv_params(rng, d=D_RWKV, ff=FF_RWKV, rank=32) -> dict:
    n = rng.standard_normal
    return {k: v.astype(np.float32) for k, v in {
        "mu": rng.uniform(0.0, 1.0, (5, d)),
        "wr": n((d, d)) * d ** -0.5, "wk": n((d, d)) * d ** -0.5,
        "wv": n((d, d)) * d ** -0.5, "wg": n((d, d)) * d ** -0.5,
        "w_bias": rng.uniform(-3.0, 0.0, (d,)),
        "w_lora_a": n((d, rank)) * d ** -0.5,
        "w_lora_b": n((rank, d)) * 0.01,
        "u": n((d // 64, 64)) * 0.5,
        "ln_scale": rng.uniform(0.5, 1.5, (d,)),
        "wo": n((d, d)) * d ** -0.5,
        "mu_c": rng.uniform(0.0, 1.0, (2, d)),
        "ck": n((d, ff)) * d ** -0.5, "cv": n((ff, d)) * ff ** -0.5,
        "cr": n((d, d)) * d ** -0.5}.items()}


# --------------------------------------------------------------------------- #
# chunked_scan
# --------------------------------------------------------------------------- #
def _body_j(c, x):
    c = c * 0.9 + x
    return c, c


def _body_t(c, x):
    c = c * 0.9 + x
    return c, c


def _plain_loop(c, xs):
    ys = []
    for x in xs:
        c, y = _body_t(c, x)
        ys.append(y)
    return c, torch.stack(ys)


@pytest.mark.parametrize("chunk", [256, 128])
def test_chunked_scan_matches_jax_and_a_plain_loop(chunk):
    xs = np.random.default_rng(0).standard_normal((512, 8)).astype(
        np.float32)
    jc, jy = j_chunked_scan(_body_j, jnp.zeros(8), jnp.asarray(xs),
                            chunk=chunk)
    tc, ty = TU.chunked_scan(_body_t, torch.zeros(8), torch.from_numpy(xs),
                             chunk=chunk)
    pc, py = _plain_loop(torch.zeros(8), torch.from_numpy(xs))
    _close(ty, jy, "f32", 1e-6)
    _close(tc, jc, "f32", 1e-6)
    assert torch.equal(ty, py) and torch.equal(tc, pc)

    # the gradient through the chunked remat
    want = jax.grad(lambda x: jnp.sum(j_chunked_scan(
        _body_j, jnp.zeros(8), x, chunk=chunk)[1] ** 2))(jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_()
    got, = torch.autograd.grad(
        (TU.chunked_scan(_body_t, torch.zeros(8), x, chunk=chunk)[1] ** 2)
        .sum(), x)
    x2 = torch.from_numpy(xs).requires_grad_()
    plain, = torch.autograd.grad((_plain_loop(torch.zeros(8), x2)[1] ** 2)
                                 .sum(), x2)
    _close(got, want, "f32", 1e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5)


def test_chunked_scan_checkpoints_each_chunk_only_under_a_gradient(
        monkeypatch):
    calls = []
    real = TU.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TU, "checkpoint", counting)
    xs = torch.randn(512, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        TU.chunked_scan(_body_t, torch.zeros(4), xs, chunk=128)
    assert calls == []                        # no gradient recorded
    with torch.enable_grad():
        TU.chunked_scan(_body_t, torch.zeros(4), xs.requires_grad_(),
                        chunk=128)
        assert calls == [{"use_reentrant": False}] * 4
        TU.chunked_scan(_body_t, torch.zeros(4), xs, chunk=128, remat=False)
        assert len(calls) == 4


@pytest.mark.parametrize("T,chunk", [(500, 256), (256, 256), (300, 0)])
def test_chunked_scan_falls_through_to_a_plain_loop(T, chunk, monkeypatch):
    """chunk 0, a chunk that does not divide T, or T <= chunk: a plain
    loop (no checkpoint), equal to the JAX scan."""
    monkeypatch.setattr(TU, "checkpoint", None)
    xs = np.random.default_rng(T).standard_normal((T, 3)).astype(np.float32)
    jc, jy = j_chunked_scan(_body_j, jnp.zeros(3), jnp.asarray(xs),
                            chunk=chunk)
    x = torch.from_numpy(xs).requires_grad_()
    tc, ty = TU.chunked_scan(_body_t, torch.zeros(3), x, chunk=chunk)
    _close(ty, jy, "f32", 1e-6)
    _close(tc, jc, "f32", 1e-6)


def test_chunked_scan_prep_runs_a_block_at_a_time_with_pytrees():
    """prep sees blocks of BLOCK (or ``chunk``) steps; its outputs feed the
    body step by step; a dict carry and tuple ys keep their structure."""
    xs = {"a": torch.randn(600, 2), "b": torch.randn(600, 2)}
    seen = []

    def prep(blk):
        seen.append(blk["a"].shape[0])
        return blk["a"] * 2.0, blk["b"]

    def body(c, inp):
        a2, b = inp
        c = {"s": c["s"] * 0.5 + a2 - b}
        return c, (c["s"], b)

    c, (ys, bs) = TU.chunked_scan(body, {"s": torch.zeros(2)}, xs,
                                  prep=prep)
    assert seen == [TU.BLOCK, TU.BLOCK, 600 - 2 * TU.BLOCK]
    s, want = torch.zeros(2), []
    for t in range(600):
        s = s * 0.5 + xs["a"][t] * 2.0 - xs["b"][t]
        want.append(s)
    assert torch.equal(ys, torch.stack(want)) and torch.equal(c["s"], s)
    assert torch.equal(bs, xs["b"])


# --------------------------------------------------------------------------- #
# the selective SSM
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_causal_conv_matches_jax(dt, with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, D_SSM)).astype(np.float32)
    w = rng.standard_normal((K_SSM, D_SSM)).astype(np.float32) * 0.5
    st = rng.standard_normal((B, K_SSM - 1, D_SSM)).astype(np.float32)
    (jx, tx), (jw, tw), (js, ts) = (_inp(a, dt) for a in (x, w, st))
    got = TS._causal_conv(tx, tw, ts if with_state else None)
    want = JS._causal_conv(jx, jw, js if with_state else None)
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt, 1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 2, 6, 512])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state"])
def test_ssm_apply_matches_jax(dt, T, with_state):
    rng = np.random.default_rng(10 + T)
    jp, tp = _both(ssm_params(rng), dt, SSM_F32)
    x = rng.standard_normal((B, T, D_SSM)).astype(np.float32)
    jx, tx = _inp(x, dt)
    jst = tst = None
    if with_state:
        h = rng.standard_normal((B, D_SSM, N_SSM)).astype(np.float32)
        conv = rng.standard_normal((B, K_SSM - 1, D_SSM)).astype(np.float32)
        jc, tc = _inp(conv, dt)
        jst = {"h": jnp.asarray(h), "conv": jc}
        tst = {"h": torch.from_numpy(h), "conv": tc}
    y, st = JS.ssm_apply(jp, jx, jst)
    ty, tst2 = TS.ssm_apply(tp, tx, tst)
    assert ty.dtype == DTYPES[dt][1] and tst2["h"].dtype == torch.float32
    assert tst2["conv"].dtype == DTYPES[dt][1]
    _close(ty, y, dt)
    _close(tst2["h"], st["h"], dt)
    _close(tst2["conv"], st["conv"], dt)
    if T == 2 and not with_state:       # the reference's zero conv tail
        assert not tst2["conv"].any()


def test_ssm_prefill_equals_stepwise():
    """``tests/test_moe_ssm.py:102`` on the port: 6 tokens in one call
    equal 6 single-token calls that carry the state."""
    rng = np.random.default_rng(4)
    _, p = _both(ssm_params(rng), "f32", SSM_F32)
    x = torch.from_numpy(rng.standard_normal((2, 6, D_SSM)).astype(
        np.float32) * 0.3)
    y_full, st_full = TS.ssm_apply(p, x)
    st = TS.ssm_init_state(2, D_SSM, N_SSM, K_SSM, torch.float32)
    ys = []
    for t in range(6):
        y_t, st = TS.ssm_apply(p, x[:, t:t + 1], state=st)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(st["h"], st_full["h"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st["conv"], st_full["conv"], rtol=0, atol=0)


def test_ssm_init_matches_the_jax_tree():
    g = torch.Generator().manual_seed(0)
    got = TS.ssm_init(g, D_SSM, N_SSM, K_SSM, torch.bfloat16)
    want = JS.ssm_init(jax.random.PRNGKey(0), D_SSM, N_SSM, K_SSM,
                       jnp.bfloat16)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k
    assert not got["dt_bias"].any() and not got["A_log"].any()
    assert bool((got["D"] == 1).all())


# --------------------------------------------------------------------------- #
# RWKV-6
# --------------------------------------------------------------------------- #
def _rwkv_case(T, dt, with_last, seed):
    rng = np.random.default_rng(seed)
    jp, tp = _both(rwkv_params(rng), dt, RWKV_F32)
    x = rng.standard_normal((B, T, D_RWKV)).astype(np.float32) * 0.5
    last = rng.standard_normal((B, D_RWKV)).astype(np.float32) * 0.5
    S0 = rng.standard_normal((B, D_RWKV // 64, 64, 64)).astype(
        np.float32) * 0.1
    jx, tx = _inp(x, dt)
    jl, tl = _inp(last, dt) if with_last else (None, None)
    return jp, tp, jx, tx, jl, tl, S0


CASES = [(T, dt, last) for T in (1, 5, 512) for dt in ("f32", "bf16")
         for last in (False, True)]
IDS = [f"T{T}-{dt}-{'last' if last else 'none'}" for T, dt, last in CASES]


@pytest.mark.parametrize("T,dt,with_last", CASES, ids=IDS)
def test_time_mix_matches_jax(T, dt, with_last):
    jp, tp, jx, tx, jl, tl, S0 = _rwkv_case(T, dt, with_last, 20 + T)
    y, S = JR.time_mix(jp, jx, jnp.asarray(S0), jl)
    ty, tS = TR.time_mix(tp, tx, torch.from_numpy(S0), tl)
    assert ty.dtype == DTYPES[dt][1] and tS.dtype == torch.float32
    _close(ty, y, dt)
    _close(tS, S, dt)


@pytest.mark.parametrize("T,dt,with_last", CASES, ids=IDS)
def test_channel_mix_matches_jax(T, dt, with_last):
    jp, tp, jx, tx, jl, tl, _ = _rwkv_case(T, dt, with_last, 30 + T)
    _close(TR.channel_mix(tp, tx, tl), JR.channel_mix(jp, jx, jl), dt)


@pytest.mark.parametrize("T,dt,with_last", CASES, ids=IDS)
def test_rwkv_block_matches_jax(T, dt, with_last):
    jp, tp, jx, tx, jl, tl, S0 = _rwkv_case(T, dt, with_last, 40 + T)
    rng = np.random.default_rng(50 + T)
    norms = [rng.standard_normal((D_RWKV,)).astype(np.float32) * 0.2
             for _ in range(2)]
    jn = [{"scale": _inp(s, dt)[0]} for s in norms]
    tn = [{"scale": _inp(s, dt)[1]} for s in norms]
    jst = tst = None
    if with_last:
        cm = rng.standard_normal((B, D_RWKV)).astype(np.float32) * 0.5
        jcm, tcm = _inp(cm, dt)
        jst = {"S": jnp.asarray(S0), "tm_last": jl, "cm_last": jcm}
        tst = {"S": torch.from_numpy(S0), "tm_last": tl, "cm_last": tcm}
    y, st = JR.rwkv_block(jp, jx, jn[0], jn[1], state=jst)
    ty, tst2 = TR.rwkv_block(tp, tx, tn[0], tn[1], state=tst)
    _close(ty, y, dt)
    for k in ("S", "tm_last", "cm_last"):
        _close(tst2[k], st[k], dt)
    # tm_last / cm_last are the block's normed inputs at the last position
    torch.testing.assert_close(tst2["tm_last"],
                               TR.rmsnorm(tn[0], tx)[:, -1], rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(j_rmsnorm(jn[0], jx)[:, -1], np.float32),
        np.asarray(st["tm_last"], np.float32))


def test_rwkv_time_mix_stepwise_equivalence():
    """``tests/test_moe_ssm.py:123`` on the port, with every leaf drawn:
    5 tokens in one call equal 5 calls that carry S and the shift."""
    rng = np.random.default_rng(6)
    _, p = _both(rwkv_params(rng), "f32", RWKV_F32)
    x = torch.from_numpy(rng.standard_normal((1, 5, D_RWKV)).astype(
        np.float32) * 0.2)
    S0 = torch.zeros((1, D_RWKV // 64, 64, 64))
    y_full, S_full = TR.time_mix(p, x, S0, None)
    S, last, ys = S0, torch.zeros((1, D_RWKV)), []
    for t in range(5):
        y_t, S = TR.time_mix(p, x[:, t:t + 1], S, last)
        last = x[:, t]
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(S, S_full, rtol=2e-4, atol=2e-4)


def test_time_mix_gradient_is_the_same_with_the_scans_remat_off():
    """T 512 runs two checkpointed chunks of 256; with ``remat=False`` the
    same blocks run without checkpoints: outputs and every gradient within
    1e-5 relative."""
    rng = np.random.default_rng(7)
    _, p = _both(rwkv_params(rng), "f32", RWKV_F32)
    x = torch.from_numpy(rng.standard_normal((1, 512, D_RWKV)).astype(
        np.float32) * 0.5)
    S0 = torch.zeros((1, D_RWKV // 64, 64, 64))
    out = {}
    for remat in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xi = x.clone().requires_grad_()
        y, S = TR.time_mix(leaves, xi, S0, None, remat=remat)
        loss = (y ** 2).sum() + S.sum()
        names = sorted(set(leaves) - {"ck", "cv", "cr", "mu_c"})
        grads = torch.autograd.grad(loss, [xi] + [leaves[k] for k in names])
        out[remat] = (y.detach(), S.detach(), grads)
    (y1, S1, g1), (y2, S2, g2) = out[True], out[False]
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=0)
    torch.testing.assert_close(S1, S2, rtol=1e-5, atol=0)
    for a, b in zip(g1, g2):
        assert float((a - b).norm() / b.norm()) <= 1e-5
        assert float(b.abs().max()) > 0


def test_rwkv_init_matches_the_jax_tree():
    g = torch.Generator().manual_seed(0)
    got = TR.rwkv_init(g, D_RWKV, FF_RWKV, torch.bfloat16)
    want = JR.rwkv_init(jax.random.PRNGKey(0), D_RWKV, FF_RWKV, jnp.bfloat16)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k
    for k in RWKV_F32:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
