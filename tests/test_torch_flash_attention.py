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
"""
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
