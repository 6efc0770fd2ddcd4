"""The port's step builders, abstract trees and dry-run helpers on the CPU,
held against the JAX package.

* ``abstract_params`` / ``abstract_cache``: the shapes and dtypes of JAX's
  ``eval_shape`` for every architecture at full widths, as meta tensors
  (nothing allocated);
* ``batch_structs``, ``serve_structs`` (both layouts) and
  ``train_state_structs``: shapes, dtypes and specs equal JAX's for every
  architecture x ``SHAPES`` entry that ``supports_shape`` accepts, on the
  16 x 16 and 2 x 16 x 16 meshes (JAX's on an ``AbstractMesh``);
* ``make_prefill_step`` / ``make_decode_step``: the logits and every cache
  leaf equal JAX's at a reduced f32 config (2e-4 of the largest
  |reference|); ``make_train_step(mesh=...)`` registers its layout;
* ``default_scan_chunks``, ``probe_layer_counts`` and
  ``probe_extrapolate`` equal JAX's, and the port's dry-run cell.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.dryrun as JD
import repro.launch.steps as JST
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supports_shape
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models.transformer import params_from_numpy

torch.set_num_threads(1)

MESHES = [(TMESH.make_production_mesh(),
           AbstractMesh((16, 16), ("data", "model"))),
          (TMESH.make_production_mesh(multi_pod=True),
           AbstractMesh((2, 16, 16), ("pod", "data", "model")))]


def _jpath(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return "/".join(parts)


def _jleaves(tree) -> dict:
    return {_jpath(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree) -> dict:
    out = {}
    TS.map_with_path(lambda p, v: out.__setitem__(TS.path_str(p), v), tree)
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _same_structs(t: dict, j: dict, with_spec: bool = True):
    assert set(t) == set(j)
    for k, jv in j.items():
        tv = t[k]
        assert tuple(tv.shape) == tuple(jv.shape), k
        assert _dtype_name(tv.dtype) == str(jv.dtype), k
        if with_spec:
            assert (tv.sharding is None) == (jv.sharding is None), k
            if jv.sharding is not None:
                assert tuple(tv.sharding.spec) == tuple(jv.sharding.spec), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_match_jax_eval_shape_and_allocate_nothing(arch):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    tp, tc = TST.abstract_params(tcfg), TST.abstract_cache(tcfg, 8, 1024)
    assert all(x.is_meta for x in leaves(tp) + leaves(tc))
    _same_structs(_tleaves(tp), _jleaves(JST.abstract_params(jcfg)), False)
    _same_structs(_tleaves(tc), _jleaves(JST.abstract_cache(jcfg, 8, 1024)),
                  False)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_serve_and_train_structs_match_jax(arch):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    for tm, jm in MESHES:
        ts, tsh = TST.train_state_structs(tcfg, tm)
        js, jsh = JST.train_state_structs(jcfg, jm)
        _same_structs(_tleaves(ts), _jleaves(js))
        assert ({k: tuple(v.spec) for k, v in _tleaves(tsh).items()}
                == {k: tuple(v.spec) for k, v in _jleaves(jsh).items()})
        for name, shape in SHAPES.items():
            if not supports_shape(tcfg, shape)[0]:
                continue
            jshape = JSHAPES[name]
            _same_structs(TST.batch_structs(tcfg, shape, tm),
                          JST.batch_structs(jcfg, jshape, jm))
            _same_structs(TST.batch_structs(tcfg, shape),
                          JST.batch_structs(jcfg, jshape))
            if shape.kind == "train":
                continue
            for serving in (False, True):
                tv = TST.serve_structs(tcfg, shape, tm, serving)
                jv = JST.serve_structs(jcfg, jshape, jm, serving)
                keys = ("params", "cache")
                assert set(tv) == set(jv)
                for k in keys:
                    if k in jv:
                        _same_structs(_tleaves(tv[k]), _jleaves(jv[k]))


STEP_ARCHS = ["gemma3-12b", "moonshot-v1-16b-a3b", "hymba-1.5b",
              "rwkv6-1.6b", "musicgen-large", "llama-3.2-vision-11b"]
B, S = 2, 12


def _map(fn, d: dict) -> dict:
    return {k: fn(v) for k, v in d.items()}


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-4 * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = JLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                tcfg.dtype, device="cpu")
    rng = np.random.default_rng(5)
    if jcfg.embeds_in:
        x = rng.standard_normal((B, S + 1, jcfg.d_model), dtype=np.float32)
        jb = lambda sl: {"embeds": jnp.asarray(x[:, sl])}
        tb = lambda sl: {"embeds": torch.from_numpy(x[:, sl])}
    else:
        x = rng.integers(0, jcfg.vocab, (B, S + 1))
        jb = lambda sl: {"ids": jnp.asarray(x[:, sl])}
        tb = lambda sl: {"ids": torch.from_numpy(x[:, sl])}
    img = {}
    if jcfg.cross_attn_every:
        img = {"img_embeds": rng.standard_normal(
            (B, jcfg.n_img_tokens, jcfg.d_model), dtype=np.float32)}

    _, jpre = JST.make_prefill_step(jcfg)
    _, tpre = TST.make_prefill_step(tcfg)
    _close(tpre(tparams, {**tb(slice(0, S)), **_map(torch.from_numpy, img)}),
           jpre(jparams, {**jb(slice(0, S)), **_map(jnp.asarray, img)}))

    # decode one token against a cache the prefill filled
    jcache = jm.init_cache(B, S + 1)
    xs = (None, jb(slice(0, S))["embeds"]) if jcfg.embeds_in else (
        jb(slice(0, S))["ids"], None)
    _, jcache = jm.prefill(jparams, xs[0], jcache,
                           **({"embeds": xs[1]} if jcfg.embeds_in else {}),
                           **_map(jnp.asarray, img))
    tm = LM(tcfg)
    tcache = tm.init_cache(B, S + 1, device="cpu")
    txs = tb(slice(0, S))
    tm.prefill(tparams, txs.get("ids"), tcache,
               **({"embeds": txs["embeds"]} if tcfg.embeds_in else {}),
               **_map(torch.from_numpy, img))
    _, jdec = JST.make_decode_step(jcfg)
    _, tdec = TST.make_decode_step(tcfg)
    jlog, jcache = jax.jit(jdec)(jparams, jcache,
                                 {**jb(slice(S, S + 1)), "pos": S})
    tlog, tcache = tdec(tparams, tcache, {**tb(slice(S, S + 1)), "pos": S})
    _close(tlog, jlog)
    jl, tl = _jleaves(jcache), _tleaves(tcache)
    assert set(jl) == set(tl)
    for k in jl:
        _close(tl[k], jl[k])


def test_step_builders_register_their_layout_and_anchor_plain_tensors():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    layout = TMESH.MeshLayout((2, 2), ("data", "model"))
    try:
        model, step = TST.make_train_step(cfg, layout, total_steps=10)
        assert TL.attention_mesh() is layout
        TL.set_attention_mesh(None)
        TST.make_prefill_step(cfg, layout)
        assert TL.attention_mesh() is layout
        TL.set_attention_mesh(None)
        TST.make_decode_step(cfg, layout)
        assert TL.attention_mesh() is layout
        # on tensors one process holds whole, the anchors change nothing
        layer0 = tree_map(lambda a: a[0],
                          model.init(torch.Generator().manual_seed(0))[
                              "layers"])
        out = TST._layer_param_constraint(layout)(layer0)
        assert all(a is b for a, b in zip(leaves(out), leaves(layer0)))
        h = torch.zeros((4, 8, cfg.d_model))
        assert TST._act_constraint(layout)(h) is h
    finally:
        TL.set_attention_mesh(None)


def test_scan_chunks_and_probe_helpers_match_jax():
    for n in range(1, 130):
        assert TD.default_scan_chunks(n) == JD.default_scan_chunks(n)
    for arch in ARCH_IDS:
        assert (TD.probe_layer_counts(get_config(arch))
                == JD.probe_layer_counts(jget_config(arch)))
    p1 = {"k": 6, "cost": {"flops": 3e12, "bytes accessed": 5e9},
          "collectives": {"all-gather": 1e8, "all-reduce": 2e7}}
    p2 = {"k": 12, "cost": {"flops": 5.5e12, "bytes accessed": 9e9},
          "collectives": {"all-gather": 1.9e8, "reduce-scatter": 4e6}}
    assert TD.probe_extrapolate(p1, p2, 48) == JD.probe_extrapolate(p1, p2,
                                                                     48)


@pytest.mark.parametrize("arch,shape", [("gemma3-12b", "train_4k"),
                                        ("moonshot-v1-16b-a3b", "decode_32k"),
                                        ("hymba-1.5b", "long_500k")])
def test_dryrun_cell_counts_per_device_bytes_as_jax_shards_them(arch, shape):
    """The port's per-device bytes equal the sum of JAX's shard shapes of
    the same trees on the same abstract mesh."""
    def jbytes(tree):
        return sum(int(np.prod(v.sharding.shard_shape(v.shape)))
                   * np.dtype(v.dtype).itemsize
                   for v in jax.tree_util.tree_leaves(tree))

    tm, jm = MESHES[1]
    rec = TD.run_cell(arch, shape, True, verbose=False)
    per = rec["bytes_per_device"]
    jcfg, jshape = jget_config(arch), JSHAPES[shape]
    assert per["batch"] == jbytes(JST.batch_structs(jcfg, jshape, jm))
    if jshape.kind == "train":
        js, _ = JST.train_state_structs(jcfg, jm)
        assert per["params"] == jbytes(js["params"])
        assert per["opt"] == jbytes(js["opt"])
    else:
        jv = JST.serve_structs(jcfg, jshape, jm)
        assert per["params"] == jbytes(jv["params"])
        assert per["cache"] == jbytes(jv["cache"])
    assert per["total"] == sum(v for k, v in per.items() if k != "total")
    assert set(rec["not_mapped"]) == {"memory_analysis", "cost_analysis",
                                      "collectives"}
    assert rec["probe"]["extrapolated"]["flops"] == pytest.approx(
        rec["cost"]["flops"], rel=1e-9)
    assert TD.run_cell("deepseek-67b", "long_500k", False,
                       verbose=False)["status"] == "skip"
