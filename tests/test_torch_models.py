"""The port's LM stack on the CPU, held against the JAX package.

* config parity for every architecture (the registry, derived per-layer
  data, parameter counts, ``reduced()``), including ``deepseek-67b``, whose
  port module once bound ``config`` to the zoo demo's widths;
* layer parity in f32 (rmsnorm, rope, expand_kv, the mask, attention
  without a cache, prefill into a cache and decode, the MLP, the lm head),
  weights and inputs drawn with numpy and handed to both;
* LM parity on reduced dense, moe, hybrid (hymba-1.5b), ssm (rwkv6-1.6b)
  and vlm (llama-3.2-vision-11b, with image embeddings drawn in the
  config's dtype) configs: JAX ``LM.init(PRNGKey(0))`` weights carried across
  with ``params_from_numpy``; ``apply`` (its hidden state and its aux,
  summed over the layers), ``prefill`` + ``logits`` and 4 ``decode_step``s
  to 1e-4 (``tests/test_models.py``), and one bf16 model of each family to
  2.5e-2 of the largest logit.  The SSM and RWKV leaves that the
  reference initialises to zeros or ones are drawn at random first (in the
  numpy tree both packages get), or the token shift, the bonus and the
  learned decay would take no part.

The JAX attention here is plain jnp (``layers.py``), and the port's runs its
flash-attention wrapper, which on the CPU is the kernel's plain version.

A moe model's top-k choices are discrete: where two experts' probabilities
tie within the two packages' rounding, each may pick its own, and in bf16
such near-ties occur.  So the JAX moe runs are eager and record every
routing decision, and the port runs with those choices pinned
(``moe.ROUTING_HOOK``), after checking that wherever its own choices
differ the JAX probabilities tie within 8x the largest difference of the
two packages' probabilities.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL
from repro.models import LM as JLM
from repro_torch import configs
from repro_torch.configs.deepseek_67b import zoo_widths
from repro_torch.models import LM, SHAPES, ArchConfig, supports_shape
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.transformer import params_from_numpy

torch.set_num_threads(1)

B, S, N_DECODE = 2, 16, 4


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_the_jax_registry(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert isinstance(got, ArchConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for c, w in ((got, want), (got.reduced(), want.reduced()),
                 (got.reduced(n_layers=6), want.reduced(n_layers=6))):
        assert dataclasses.asdict(c) == dataclasses.asdict(w)
        np.testing.assert_array_equal(c.layer_windows, w.layer_windows)
        np.testing.assert_array_equal(c.layer_thetas, w.layer_thetas)
        np.testing.assert_array_equal(c.is_cross_layer, w.is_cross_layer)
        assert (c.hd, c.vocab_padded) == (w.hd, w.vocab_padded)
        assert c.n_params == w.n_params
        assert c.n_params_active == w.n_params_active
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jconfigs.SHAPES[name])
        assert supports_shape(got, shape) == jconfigs.supports_shape(want,
                                                                     shape)


def test_deepseek_config_is_the_architecture_and_the_zoo_keeps_its_widths():
    cfg = configs.get_config("deepseek-67b")
    assert isinstance(cfg, ArchConfig) and cfg.n_layers == 95
    assert dataclasses.asdict(zoo_widths) == {
        "d": 8192, "n_heads": 64, "ff": 22016, "vocab": 102400,
        "n_layers": 2}
    assert (zoo_widths.d, zoo_widths.ff, zoo_widths.vocab) == (
        cfg.d_model, cfg.d_ff, cfg.vocab)
    assert zoo_widths.d // zoo_widths.n_heads == cfg.hd


def test_gemma3_at_six_layers_has_one_global_layer():
    c = configs.get_config("gemma3-12b").reduced(n_layers=6)
    assert list(c.layer_windows) == [8, 8, 8, 8, 8, 0]
    assert list(c.layer_thetas) == [1e4] * 5 + [1e6]
    assert list(configs.get_config("gemma3-12b").reduced().layer_windows) \
        == [8, 8, 8, 8]


# --------------------------------------------------------------------------- #
# layers (f32)
# --------------------------------------------------------------------------- #
D, H, KV, HD, FF, V = 64, 4, 2, 16, 128, 96


@pytest.fixture(scope="module")
def attn_weights():
    rng = np.random.default_rng(0)
    w = {"wq": rng.standard_normal((D, H, HD)) * D ** -0.5,
         "wk": rng.standard_normal((D, KV, HD)) * D ** -0.5,
         "wv": rng.standard_normal((D, KV, HD)) * D ** -0.5,
         "wo": rng.standard_normal((H * HD, D)) * (H * HD) ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return w, {k: jnp.asarray(v) for k, v in w.items()}, \
        {k: _t(v) for k, v in w.items()}


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    s = rng.standard_normal((D,), dtype=np.float32) * 0.2
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": _t(s)}, _t(x)).numpy(),
        _np(JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    xr = rng.standard_normal((B, S, H, HD), dtype=np.float32)
    pos = np.arange(3, 3 + S, dtype=np.int32)[None]
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            TL.apply_rope(_t(xr), torch.from_numpy(pos), theta).numpy(),
            _np(JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                              np.float32(theta))),
            rtol=1e-5, atol=1e-5)


def test_expand_kv_and_mask_match():
    rng = np.random.default_rng(2)
    kv = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    np.testing.assert_array_equal(TL.expand_kv(_t(kv), H).numpy(),
                                  _np(JL.expand_kv(jnp.asarray(kv), H)))
    assert TL.expand_kv(_t(kv), H).is_contiguous()
    # one head a group, from a slice of a longer cache: still contiguous
    part = _t(kv)[:, :S - 3]
    assert not part.is_contiguous()
    assert TL.expand_kv(part, KV).is_contiguous()
    assert torch.equal(TL.expand_kv(part, KV), part)
    qp, kp = np.arange(5, 9), np.arange(12)
    for window in (0, 3, -1):
        for causal in (True, False):
            np.testing.assert_array_equal(
                TL.attn_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                             window, causal).numpy(),
                np.asarray(JL.attn_mask(jnp.asarray(qp), jnp.asarray(kp),
                                        window, causal)))


@pytest.mark.parametrize("window", [0, 5])
def test_attention_forward_prefill_and_decode_match(attn_weights, window):
    _, jw, tw = attn_weights
    rng = np.random.default_rng(3 + window)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    # forward pass without a cache
    y, _ = TL.attention(tw, _t(x), None, theta=1e4, window=window)
    yj, _ = JL.attention(jw, jnp.asarray(x), None, theta=1e4, window=window)
    np.testing.assert_allclose(y.numpy(), _np(yj), rtol=1e-4, atol=1e-4)
    # prefill into an empty cache of S + 3 rows, then one decode step
    M = S + 3
    tc = {"k": torch.zeros((B, M, KV, HD)), "v": torch.zeros((B, M, KV, HD))}
    jc = {"k": jnp.zeros((B, M, KV, HD)), "v": jnp.zeros((B, M, KV, HD))}
    y, tc = TL.attention(tw, _t(x), None, theta=1e4, window=window,
                         cache=tc, cache_pos=0)
    yj, jc = JL.attention(jw, jnp.asarray(x), None, theta=1e4, window=window,
                          cache=jc, cache_pos=0)
    np.testing.assert_allclose(y.numpy(), _np(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), _np(jc["k"]), rtol=1e-5,
                               atol=1e-5)
    x1 = rng.standard_normal((B, 1, D), dtype=np.float32)
    y, tc = TL.attention(tw, _t(x1), None, theta=1e4, window=window,
                         cache=tc, cache_pos=S)
    yj, jc = JL.attention(jw, jnp.asarray(x1), None, theta=1e4,
                          window=window, cache=jc, cache_pos=S)
    np.testing.assert_allclose(y.numpy(), _np(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc["v"].numpy(), _np(jc["v"]), rtol=1e-5,
                               atol=1e-5)


def test_mlp_and_lm_logits_match():
    rng = np.random.default_rng(4)
    wi = (rng.standard_normal((D, 2, FF)) * D ** -0.5).astype(np.float32)
    wo = (rng.standard_normal((FF, D)) * FF ** -0.5).astype(np.float32)
    table = rng.standard_normal((V + 32, D), dtype=np.float32)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    np.testing.assert_allclose(
        TL.mlp({"wi": _t(wi), "wo": _t(wo)}, _t(x)).numpy(),
        _np(JL.mlp({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
                   jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    got = TL.lm_logits({"table": _t(table)}, _t(x), V)
    assert got.shape == (B, S, V) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _np(JL.lm_logits({"table": jnp.asarray(table)},
                                      jnp.asarray(x), V)),
        rtol=1e-4, atol=1e-4)
    ids = rng.integers(0, V, (B, S))
    np.testing.assert_array_equal(
        TL.embed({"table": _t(table)}, torch.from_numpy(ids)).numpy(),
        _np(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))))


# --------------------------------------------------------------------------- #
# the LM, with JAX weights carried across
# --------------------------------------------------------------------------- #
LM_CASES = {
    "deepseek-67b": lambda c: c.reduced(),
    "mistral-large-123b": lambda c: c.reduced(),
    "gemma3-12b": lambda c: c.reduced(n_layers=6),
    "musicgen-large": lambda c: c.reduced(),
    "gemma3-12b-bf16": lambda c: c.reduced(n_layers=6, dtype="bfloat16"),
    "moonshot-v1-16b-a3b": lambda c: c.reduced(),
    "qwen3-moe-235b-a22b": lambda c: c.reduced(),
    "moonshot-v1-16b-a3b-bf16": lambda c: c.reduced(dtype="bfloat16"),
    "hymba-1.5b": lambda c: c.reduced(),
    "rwkv6-1.6b": lambda c: c.reduced(),
    "hymba-1.5b-bf16": lambda c: c.reduced(dtype="bfloat16"),
    "rwkv6-1.6b-bf16": lambda c: c.reduced(dtype="bfloat16"),
    "llama-3.2-vision-11b": lambda c: c.reduced(),
    "llama-3.2-vision-11b-bf16": lambda c: c.reduced(dtype="bfloat16"),
}

# the leaves the reference initialises to zeros or ones (``ssm_init``,
# ``rwkv_init``), drawn instead: name -> (low, high) of a uniform draw
STATE_LEAF_DRAWS = {"dt_bias": (-2.0, 0.0), "A_log": (-1.0, 1.0),
                    "D": (0.5, 1.5), "mu": (0.0, 1.0), "mu_c": (0.0, 1.0),
                    "w_bias": (-3.0, 0.0), "u": (-0.5, 0.5),
                    "ln_scale": (0.5, 1.5)}


def draw_state_leaves(tree, rng):
    """``tree`` (numpy) with every ``STATE_LEAF_DRAWS`` leaf under an
    ``ssm`` or ``rwkv`` node replaced by a uniform draw of its shape and
    type."""
    def walk(t, inside):
        if isinstance(t, dict):
            return {k: walk(v, inside or k in ("ssm", "rwkv")) if
                    isinstance(v, dict) or not (inside and k in
                                                STATE_LEAF_DRAWS)
                    else rng.uniform(*STATE_LEAF_DRAWS[k], v.shape)
                    .astype(v.dtype) for k, v in t.items()}
        return t
    return walk(tree, False)


def _case_config(case):
    arch = case.removesuffix("-bf16")
    return (LM_CASES[case](jconfigs.get_config(arch)),
            LM_CASES[case](configs.get_config(arch)))


@contextlib.contextmanager
def _jax_choices(rec: list | None):
    """Run the JAX model eagerly, appending each routing decision's
    (probabilities, top-k indices) to ``rec``; nothing for ``rec=None``."""
    if rec is None:
        yield
        return
    real = jax.lax.top_k

    def top_k(x, k):
        out = real(x, k)
        rec.append((np.asarray(x, np.float32), np.asarray(out[1])))
        return out

    jax.lax.top_k = top_k
    try:
        with jax.disable_jit():
            yield
    finally:
        jax.lax.top_k = real


@contextlib.contextmanager
def _pinned(rec: list | None):
    """Pin the port's routing decisions, call by call, to the JAX run's
    ``rec``; fail where the port's own choice differs from JAX's and the
    JAX probabilities do not tie within 8x the two packages' largest
    probability difference."""
    if rec is None:
        yield
        return
    queue = list(rec)

    def hook(router, logits, idx):
        probs, jidx = queue.pop(0)
        k = jidx.shape[-1]
        drift = np.abs(torch.softmax(logits, -1).numpy() - probs).max()
        top = -np.sort(-probs, axis=-1)
        gap = top[..., k - 1] - top[..., k]
        flip = (np.sort(idx.numpy(), -1) != np.sort(jidx, -1)).any(-1)
        assert (gap[flip] <= 8 * drift).all(), (gap[flip], drift)
        return torch.from_numpy(jidx.astype(np.int64))

    TM.ROUTING_HOOK = hook
    try:
        yield
    finally:
        TM.ROUTING_HOOK = None
    assert not queue


@pytest.fixture(scope="module")
def lm_runs():
    """One JAX model per case, run once: apply, prefill + logits, and
    N_DECODE jitted decode steps; the same inputs for the port."""
    cache = {}

    def run(case):
        if case in cache:
            return cache[case]
        jc, tc = _case_config(case)
        m = JLM(jc)
        params = jax.tree.map(jnp.asarray, draw_state_leaves(
            jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0))),
            np.random.default_rng(12)))
        rng = np.random.default_rng(11)
        ids = rng.integers(0, jc.vocab, (B, S + N_DECODE))
        embeds = (rng.standard_normal((B, S + N_DECODE, jc.d_model),
                                      dtype=np.float32)
                  if jc.embeds_in else None)
        # image embeddings in the config's dtype (f32 ones into a bf16
        # model break the JAX layer scan: tests/test_torch_vlm.py)
        img = (np.asarray(jnp.asarray(rng.standard_normal(
            (B, jc.n_img_tokens, jc.d_model)), jnp.dtype(jc.dtype)))
            if jc.cross_attn_every else None)
        img_kw = {"img_embeds": jnp.asarray(img)} if img is not None else {}

        def inp(sl):
            if jc.embeds_in:
                return None, {"embeds": jnp.asarray(embeds[:, sl])}
            return jnp.asarray(ids[:, sl]), {}

        choices = ({k: [] for k in ("apply", "prefill", "decode")}
                   if jc.n_experts else dict.fromkeys(("apply", "prefill",
                                                       "decode")))
        x, kw = inp(slice(0, S))
        with _jax_choices(choices["apply"]):
            h, aux = m.apply(params, x, remat=False, **kw, **img_kw)
        jcache = m.init_cache(B, S + N_DECODE)
        with _jax_choices(choices["prefill"]):
            hp, jcache = m.prefill(params, x, jcache, **kw, **img_kw)
        step = jax.jit(lambda p, c, x, kw, pos: m.decode_step(
            p, x, c, pos, **kw))
        dec = []
        with _jax_choices(choices["decode"]):
            for t in range(S, S + N_DECODE):
                x, kw = inp(slice(t, t + 1))
                lg, jcache = step(params, jcache, x, kw, t)
                dec.append(np.asarray(lg, np.float32))
        cache[case] = {
            "tc": tc, "ids": ids, "embeds": embeds, "img": img,
            "choices": choices,
            "params": jax.tree.map(np.asarray, params),
            "logits_apply": np.asarray(m.logits(params, h), np.float32),
            "h_apply": np.asarray(h, np.float32),
            "aux_apply": {k: float(v) for k, v in aux.items()},
            "logits_prefill": np.asarray(m.logits(params, hp), np.float32),
            "decode": dec}
        return cache[case]
    return run


def _port_inputs(r, sl):
    if r["tc"].embeds_in:
        return None, {"embeds": _t(r["embeds"][:, sl])}
    return torch.from_numpy(r["ids"][:, sl]), {}


def _port_img(r):
    """The vlm case's image embeddings, in the config's dtype."""
    if r["img"] is None:
        return {}
    return {"img_embeds": _t(r["img"]).to(getattr(torch, r["tc"].dtype))}


def _tol(case):
    return 2.5e-2 if case.endswith("bf16") else 1e-4


def _close(got, want, case):
    got = got.float().numpy()
    if case.endswith("bf16"):        # relative to the largest value
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= _tol(case) * scale
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_apply_matches_jax(lm_runs, case):
    r = lm_runs(case)
    m = LM(r["tc"])
    p = params_from_numpy(r["params"], r["tc"].dtype, device="cpu")
    mixer = p["layers"]["rwkv" if r["tc"].rwkv else "attn"]
    assert mixer["wo"].dtype == getattr(torch, r["tc"].dtype)
    x, kw = _port_inputs(r, slice(0, S))
    with _pinned(r["choices"]["apply"]):
        h, aux = m.apply(p, x, **kw, **_port_img(r))
    assert h.shape == (B, S, r["tc"].d_model)
    assert set(aux) == set(r["aux_apply"])
    for k, want in r["aux_apply"].items():
        assert aux[k].dtype == torch.float32 and aux[k].shape == ()
        np.testing.assert_allclose(float(aux[k]), want, rtol=_tol(case),
                                   atol=1e-6)
    if not r["tc"].n_experts:
        assert all(float(v) == 0.0 for v in aux.values())
    _close(h, r["h_apply"], case)
    _close(m.logits(p, h), r["logits_apply"], case)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_prefill_and_decode_match_jax(lm_runs, case):
    r = lm_runs(case)
    m = LM(r["tc"])
    p = params_from_numpy(r["params"], r["tc"].dtype, device="cpu")
    cache = m.init_cache(B, S + N_DECODE, device="cpu")
    x, kw = _port_inputs(r, slice(0, S))
    with _pinned(r["choices"]["prefill"]):
        hp, cache = m.prefill(p, x, cache, **kw, **_port_img(r))
    _close(m.logits(p, hp), r["logits_prefill"], case)
    with _pinned(r["choices"]["decode"]):
        for i, t in enumerate(range(S, S + N_DECODE)):
            x, kw = _port_inputs(r, slice(t, t + 1))
            lg, cache = m.decode_step(p, x, cache, t, **kw)
            assert lg.shape == (B, 1, r["tc"].vocab)
            _close(lg, r["decode"][i], case)


@pytest.mark.parametrize("arch", ["gemma3-12b", "hymba-1.5b", "rwkv6-1.6b"])
def test_init_draws_the_config_dtype_on_the_generator_device(arch):
    c = configs.get_config(arch).reduced(dtype="bfloat16")
    p = LM(c).init(torch.Generator().manual_seed(0))
    if not c.rwkv:
        assert p["layers"]["attn"]["wq"].shape == (c.n_layers, c.d_model,
                                                   c.n_heads, c.hd)
        assert p["layers"]["mlp"]["wi"].shape == (c.n_layers, c.d_model, 2,
                                                  c.d_ff)
    assert p["embed"]["table"].shape == (c.vocab_padded, c.d_model)
    assert all(t.dtype == torch.bfloat16 for t in
               (p["embed"]["table"], p["final_norm"]["scale"],
                p["layers"]["ln1"]["scale"]))
    jtree = jax.eval_shape(JLM(jconfigs.get_config(arch).reduced(
        dtype="bfloat16")).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: tuple(a.shape), jtree) == \
        jax.tree.map(lambda t: tuple(t.shape), p)
    # each leaf's type, the f32 leaves of the ssm and rwkv blocks included
    assert jax.tree.map(lambda a: str(a.dtype), jtree) == \
        jax.tree.map(lambda t: str(t.dtype).removeprefix("torch."), p)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_params_from_numpy_keeps_the_f32_leaves_of_a_bf16_model(arch):
    jc = jconfigs.get_config(arch).reduced(dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JLM(jc).init(jax.random.PRNGKey(0)))
    p = params_from_numpy(jp, jc.dtype, device="cpu")
    got = jax.tree.map(lambda t: str(t.dtype).removeprefix("torch."), p)
    assert got == jax.tree.map(lambda a: str(a.dtype), jp)
    block = p["layers"]["rwkv" if jc.rwkv else "ssm"]
    f32 = (("mu", "w_bias", "u", "ln_scale", "mu_c") if jc.rwkv else
           ("dt_bias", "A_log", "D"))
    assert {k for k, v in block.items() if v.dtype == torch.float32} == \
        set(f32)
    assert p["layers"]["ln1"]["scale"].dtype == torch.bfloat16
