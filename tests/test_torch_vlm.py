"""The port's vlm family (llama-3.2-vision-11b) on the CPU, held against the
JAX package.

* ``layers.attention(kv_x=)`` (q from x, k and v from the image rows, no
  rope, no mask) at T = 12, where the JAX function takes its plain softmax,
  and at T = 2048, where it takes ``_attend_chunked(causal=False)``;
* ``_cross_from_cache`` in a prefill (the port's K7, whose CPU version is
  its plain softmax) and in decode (T = 1, plain in both);
* ``LM.init``'s tree (``layers`` [G, per, ...], ``cross`` [G, ...]): every
  leaf's shape and type;
* a reduced model's ``LM.apply`` at S = 2048 (every attention on the
  chunked JAX branch), and ``prefill`` + ``decode_step``: logits, the self
  k/v cache and the cross ``ck``/``cv`` cache after the prefill and after
  the decode steps, at ``cross_attn_every`` 2 and 3;
* one training step's loss and every gradient leaf against
  ``jax.value_and_grad`` (group remat on and off), the cross layers' wq,
  wk, wv and wo among them (drawn image embeddings: the JAX trainer's zeros
  give those leaves no gradient);
* ``_vlm_groups``' ``ValueError``;
* the reference's hazard with f32 image embeddings in a bf16 model (its
  layer scan raises ``TypeError``), and ``serve_lm`` handing the model
  embeddings in its own dtype.

Weights come from the JAX ``LM.init`` through ``params_from_numpy``; image
embeddings are numpy normal draws in the config's dtype, handed to both.
Tolerances are the reference's: f32 1e-4 (``tests/test_models.py``), a
gradient leaf 2e-4 of its largest |ref| (``tests/test_torch_train.py``),
bf16 2.5e-2 of the largest |ref|; a bf16 gradient leaf is held to the f32
gradient of the same weights, within 1.5x the JAX bf16 gradient's error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL
import repro.models.transformer as JT
from repro.models import LM as JLM
from repro_torch import configs
from repro_torch.core.tree import flatten, leaves, unflatten
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import params_from_numpy

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b"
DTYPES = {"f32": "float32", "bf16": "bfloat16"}
B, S, N_DECODE = 2, 12, 3
D, H, KV, HD, M = 32, 4, 2, 8, 16


def _cfgs(dtype="float32", **kw):
    """(JAX, port) reduced llama-3.2-vision-11b configs: d 64, 4 heads x 16
    over 2 kv heads, 16 image tokens; 2 groups of (1 self + 1 cross)
    unless ``kw`` says otherwise."""
    return (jconfigs.get_config(ARCH).reduced(dtype=dtype, **kw),
            configs.get_config(ARCH).reduced(dtype=dtype, **kw))


def _in_dtype(a, dtype: str):
    """numpy f32 ``a`` in ``dtype`` (bf16 as ``ml_dtypes.bfloat16``)."""
    return np.asarray(jnp.asarray(a, jnp.dtype(dtype)))


def _t(a, dtype: str = "float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, dtype: str, tol: float = 1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "bfloat16":              # relative to the largest value
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2.5e-2 * scale, \
            np.abs(got - want).max() / scale
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _attn_weights(rng, dtype):
    w = {"wq": rng.standard_normal((D, H, HD)) * D ** -0.5,
         "wk": rng.standard_normal((D, KV, HD)) * D ** -0.5,
         "wv": rng.standard_normal((D, KV, HD)) * D ** -0.5,
         "wo": rng.standard_normal((H * HD, D)) * (H * HD) ** -0.5}
    w = {k: _in_dtype(v, dtype) for k, v in w.items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: _t(v, dtype) for k, v in w.items()})


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("T", [S, 2 * JL.Q_CHUNK], ids=["plain", "chunked"])
def test_cross_attention_matches_jax(monkeypatch, T, dtype):
    rng = np.random.default_rng(T)
    jw, tw = _attn_weights(rng, dtype)
    x = _in_dtype(rng.standard_normal((B, T, D)), dtype)
    img = _in_dtype(rng.standard_normal((B, M, D)), dtype)
    chunked = []
    real = JL._attend_chunked

    def spy(*a, **kw):
        chunked.append(a[5])                    # its causal flag
        return real(*a, **kw)

    monkeypatch.setattr(JL, "_attend_chunked", spy)
    want, _ = JL.attention(jw, jnp.asarray(x), None, theta=1e4,
                           kv_x=jnp.asarray(img))
    assert chunked == ([False] if T >= 2 * JL.Q_CHUNK else [])
    got, cache = TL.attention(tw, _t(x, dtype), None, theta=1e4,
                              kv_x=_t(img, dtype))
    assert cache is None and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("T", [S, 1], ids=["prefill", "decode"])
def test_cross_from_cache_matches_jax(T, dtype):
    rng = np.random.default_rng(40 + T)
    jw, tw = _attn_weights(rng, dtype)
    h = _in_dtype(rng.standard_normal((B, T, D)), dtype)
    kv = {n: _in_dtype(rng.standard_normal((B, M, KV, HD)), dtype)
          for n in ("ck", "cv")}
    want, _ = JT._cross_from_cache({"attn": jw}, jnp.asarray(h),
                                   {n: jnp.asarray(a) for n, a in kv.items()})
    got = TT._cross_from_cache({"attn": tw}, _t(h, dtype),
                               {n: _t(a, dtype) for n, a in kv.items()},
                               prefill=T > 1)
    _close(got, want, dtype)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("every", [2, 3])
def test_init_tree_is_the_jax_tree(every, dtype):
    jc, tc = _cfgs(dtype, cross_attn_every=every, n_layers=2 * every)
    p = LM(tc).init(torch.Generator().manual_seed(0))
    jtree = jax.eval_shape(JLM(jc).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jtree) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix("torch.")), p)
    assert p["layers"]["attn"]["wq"].shape[:2] == (2, every - 1)
    assert p["cross"]["mlp"]["wi"].shape[0] == 2 and "moe" not in p["cross"]
    cache = LM(tc).init_cache(B, S, device="cpu")
    jcache = jax.eval_shape(lambda: JLM(jc).init_cache(B, S))
    assert jax.tree.map(lambda a: tuple(a.shape), jcache) == \
        jax.tree.map(lambda t: tuple(t.shape), cache)


def test_layers_not_a_multiple_of_the_group_raise():
    jc, tc = _cfgs(n_layers=5)
    with pytest.raises(ValueError, match="not divisible"):
        JLM(jc)._vlm_groups()
    with pytest.raises(ValueError, match="not divisible by cross_attn_every"):
        LM(tc).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible"):
        serve.serve_lm(serve.lm_config(ARCH, layers=5), prompt_len=4,
                       tokens=1, device="cpu")


def _img(cfg, batch: int, seed: int):
    return _in_dtype(np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_img_tokens, cfg.d_model)), cfg.dtype)


MODEL_CASES = {"f32": ("float32", 2), "bf16": ("bfloat16", 2),
               "f32-every3": ("float32", 3)}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_decode_and_both_caches_match_jax(case):
    dtype, every = MODEL_CASES[case]
    jc, tc = _cfgs(dtype, cross_attn_every=every, n_layers=2 * every)
    jm, m = JLM(jc), LM(tc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    p = params_from_numpy(jp, tc.dtype, device="cpu")
    ids = np.random.default_rng(7).integers(0, jc.vocab, (B, S + N_DECODE))
    img = _img(jc, B, 8)

    jcache = jm.init_cache(B, S + N_DECODE)
    hp, jcache = jm.prefill(jp, jnp.asarray(ids[:, :S]), jcache,
                            img_embeds=jnp.asarray(img))
    cache = m.init_cache(B, S + N_DECODE, device="cpu")
    ck = cache["cross"]["ck"]
    fa.reset_launches()
    got, cache = m.prefill(p, torch.from_numpy(ids[:, :S]), cache,
                           img_embeds=_t(img, dtype))
    assert cache["cross"]["ck"] is ck                   # written in place
    _close(m.logits(p, got), jm.logits(jp, hp), dtype)
    for part in ("self", "cross"):
        for n in cache[part]:
            _close(cache[part][n], jcache[part][n], dtype, tol=1e-5)
    step = jax.jit(lambda c, x, pos: jm.decode_step(jp, x, c, pos))
    for t in range(S, S + N_DECODE):
        want, jcache = step(jcache, jnp.asarray(ids[:, t:t + 1]), t)
        lg, cache = m.decode_step(p, torch.from_numpy(ids[:, t:t + 1]),
                                  cache, t)
        _close(lg, want, dtype)
    for part in ("self", "cross"):
        for n in cache[part]:
            _close(cache[part][n], jcache[part][n], dtype, tol=1e-5)
    assert all(v == 0 for v in fa.LAUNCHES.values())      # CPU: plain


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_apply_at_the_chunked_length_matches_jax(dtype):
    """S = 2048: every JAX self- and cross-attention takes its chunked
    branch; the port's take K7 (its plain version here)."""
    jc, tc = _cfgs(dtype)
    jm = JLM(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    T = 2 * JL.Q_CHUNK
    ids = np.random.default_rng(9).integers(0, jc.vocab, (1, T))
    img = _img(jc, 1, 10)
    want, _ = jm.apply(jp, jnp.asarray(ids), img_embeds=jnp.asarray(img),
                       remat=False)
    got, aux = LM(tc).apply(params_from_numpy(jp, tc.dtype, device="cpu"),
                            torch.from_numpy(ids), img_embeds=_t(img, dtype),
                            remat=False)
    assert all(float(v) == 0.0 for v in aux.values())
    _close(got, want, dtype)


def test_image_embeddings_must_come_in_the_model_dtype():
    jc, tc = _cfgs("bfloat16")
    m = LM(tc)
    p = m.init(torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="img_embeds are torch.float32"):
        m.apply(p, ids, img_embeds=torch.zeros((1, tc.n_img_tokens,
                                                tc.d_model)))
    with pytest.raises(ValueError, match="needs img_embeds"):
        m.prefill(p, ids, m.init_cache(1, 4, device="cpu"))


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def _leaf_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


TRAIN_CASES = {"f32": ("float32", 2, True), "f32-no-remat": ("float32", 2,
                                                             False),
               "f32-every3": ("float32", 3, True),
               "bf16": ("bfloat16", 2, True)}


def _jax_loss_and_grads(jm, jp, ids, labels, mask, img, remat):
    def loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(ids), img_embeds=jnp.asarray(img),
                        remat=remat)
        return jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                       chunk=16)

    loss, g = jax.value_and_grad(loss_fn)(jp)
    return float(loss), [np.asarray(a, np.float32) for a in
                         jax.tree.leaves(g)]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_loss_and_gradients_match_jax(case):
    """f32: each gradient leaf within 2e-4 of its largest |ref|.  bf16,
    where both packages round every product and sum to bf16 in their own
    order (~1.5% of a leaf's norm apart): the loss within 2.5e-3, and each
    leaf no further from the f32 gradient of the same weights than 1.5x the
    JAX bf16 gradient is (the SDPA-control rule of ``chip_smoke.py``)."""
    dtype, every, remat = TRAIN_CASES[case]
    jc, tc = _cfgs(dtype, cross_attn_every=every, n_layers=2 * every)
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(11)
    ids = rng.integers(0, jc.vocab, (B, 32))
    labels = rng.integers(0, jc.vocab, (B, 32))
    mask = (rng.random((B, 32)) < 0.8).astype(np.float32)
    img = _img(jc, B, 12)
    want_loss, want_g = _jax_loss_and_grads(jm, jp, ids, labels, mask, img,
                                            remat)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc.dtype,
                           device="cpu")
    batch = {"ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask), "img_embeds": _t(img, dtype)}
    loss, grads, _ = loss_and_grads(LM(tc), tp, batch, remat=remat,
                                    loss_chunk=16)
    assert len(grads) == len(want_g) == len(leaves(tp))
    names = _names(tp)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), want_loss, rtol=2e-5)
        errs = {n: _leaf_err(g, w) for n, g, w in zip(names, grads, want_g)}
        assert max(errs.values()) <= 2e-4, errs
    else:
        np.testing.assert_allclose(float(loss), want_loss, rtol=2.5e-3)
        jc32 = _cfgs("float32", cross_attn_every=every,
                     n_layers=2 * every)[0]
        _, f32_g = _jax_loss_and_grads(
            JLM(jc32), jax.tree.map(lambda a: a.astype(jnp.float32), jp),
            ids, labels, mask, img.astype(np.float32), remat)
        ratio = {n: float(np.linalg.norm(g.float().numpy() - f)
                          / np.linalg.norm(w - f))
                 for n, g, w, f in zip(names, grads, want_g, f32_g)}
        assert max(ratio.values()) <= 1.5, ratio
    for n in ("wq", "wk", "wv", "wo"):                  # the cross layers'
        g = unflatten(flatten(tp)[1], grads)["cross"]["attn"][n]
        assert float(g.abs().max()) > 0


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


def test_the_trainer_feeds_zero_image_embeddings_as_the_reference():
    """``launch.train.build`` feeds zeros in the config dtype, as the JAX
    launcher does, and the CLI trains the reduced model on them."""
    from repro_torch.launch import train as ttrain

    tc = _cfgs()[1]
    state, step, data = ttrain.build(tc, 4, 3e-3, 16, 2, device="cpu")
    seen = {}
    real = LM.apply

    def spy(self, params, ids=None, **kw):
        seen["img"] = kw["img_embeds"]
        return real(self, params, ids, **kw)

    LM.apply = spy
    try:
        _, met = step(state, data.batch(0))
    finally:
        LM.apply = real
    img = seen["img"]
    assert img.shape == (2, tc.n_img_tokens, tc.d_model)
    assert img.dtype == torch.float32 and not img.any()
    assert np.isfinite(float(met["loss"]))


# --------------------------------------------------------------------------- #
# hazard 1 of the reference: f32 image embeddings into a bf16 model
# --------------------------------------------------------------------------- #
def test_f32_image_embeddings_break_the_jax_bf16_model_not_serve_lm():
    jc, tc = _cfgs("bfloat16")
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    ids = np.random.default_rng(3).integers(0, jc.vocab, (1, 6))
    img32 = np.random.default_rng(4).standard_normal(
        (1, jc.n_img_tokens, jc.d_model)).astype(np.float32)
    with pytest.raises(TypeError, match="carry"):
        jm.prefill(jp, jnp.asarray(ids), jm.init_cache(1, 8),
                   img_embeds=jnp.asarray(img32))
    seen = {}
    real = LM.prefill

    def spy(self, params, x, cache, **kw):
        seen["img"] = kw["img_embeds"]
        return real(self, params, x, cache, **kw)

    LM.prefill = spy
    try:
        st = serve.serve_lm(tc, params_from_numpy(
            jax.tree.map(np.asarray, jp), tc.dtype, device="cpu"), ids,
            tokens=2, device="cpu", img_embeds=img32)
    finally:
        LM.prefill = real
    assert seen["img"].dtype == torch.bfloat16
    assert torch.equal(seen["img"], _t(img32).bfloat16())
    assert st["finite"] and st["ids"].shape == (1, 2)
