"""The port's mesh layouts and sharding rules on the CPU, held against the
JAX package.

* ``param_spec`` for every leaf of every architecture's parameters at full
  widths, and ``cache_spec`` for every leaf of its cache, on the 16 x 16,
  2 x 16 x 16 and (16, 4, 4) pipeline meshes (JAX's side on an
  ``AbstractMesh``, which needs no devices); a leaf's path is its keys
  joined by "/" on both sides;
* ``drop_data``, the serving layout, ``opt_shardings``, ``batch_spec``,
  ``act_spec`` and ``guard_spec``;
* ``moe_groups`` under a registered layout, and ``moe_apply`` routing in a
  layout's groups against the JAX ``moe_apply`` with the same
  ``n_groups``;
* one 4-rank gloo run on a (2, 2) ``DeviceMesh``: the DTensor placements
  give each rank the shard shapes the specs imply, ``_con_heads``
  redistributes a replicated tensor to its spec, and
  ``DeviceInventory.from_mesh`` lists the positions in ``np.ndindex``
  order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.launch.mesh as jmesh
import repro.launch.sharding as JS
import repro.models.layers as JL
import repro.models.moe as JM
from repro.configs import get_config as jget_config
from repro.launch.steps import abstract_cache as j_abstract_cache
from repro.launch.steps import abstract_params as j_abstract_params
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch.steps import abstract_cache, abstract_params
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.optim import adamw_init

from torch_spmd_ranks import placement_rank

torch.set_num_threads(1)

MESHES = {
    "16x16": (TMESH.make_production_mesh(),
              AbstractMesh((16, 16), ("data", "model"))),
    "2x16x16": (TMESH.make_production_mesh(multi_pod=True),
                AbstractMesh((2, 16, 16), ("pod", "data", "model"))),
    "16x4x4": (TMESH.make_pipeline_mesh(n_stages=4),
               AbstractMesh((16, 4, 4), ("data", "stage", "model"))),
}


def _jpath(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return "/".join(parts)


def _jleaves(tree, is_leaf=None) -> dict:
    return {_jpath(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _tleaves(tree) -> dict:
    out = {}
    TS.map_with_path(lambda p, v: out.__setitem__(TS.path_str(p), v), tree)
    return out


def _same_specs(t_specs: dict, j_specs: dict):
    assert set(t_specs) == set(j_specs)
    for k in j_specs:
        assert tuple(t_specs[k]) == tuple(j_specs[k]), (k, t_specs[k],
                                                        j_specs[k])


def test_meshes_and_batch_axes_match_jax_layouts():
    for name, (tm, jm) in MESHES.items():
        assert tm.axis_names == jm.axis_names, name
        assert tm.shape == dict(jm.shape), name
        assert tm.size == jm.size
        assert TMESH.batch_axes(tm) == jmesh.batch_axes(jm)
    assert TMESH.make_pipeline_mesh(n_stages=2, multi_pod=True).shape == {
        "pod": 2, "data": 16, "stage": 2, "model": 8}
    with pytest.raises(ValueError, match="divide 16"):
        TMESH.make_pipeline_mesh(n_stages=3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax_for_every_leaf(arch):
    jp = _jleaves(j_abstract_params(jget_config(arch)))
    tp = _tleaves(abstract_params(get_config(arch)))
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    for name, (tm, jm) in MESHES.items():
        _same_specs({k: TS.param_spec(tm, k, v) for k, v in tp.items()},
                    {k: JS.param_spec(jm, k.split("/"), v)
                     for k, v in jp.items()})
        # the serving layout drops "data" and nothing else
        _same_specs({k: s.spec for k, s in _tleaves(
                        TS.param_shardings_serving(
                            tm, abstract_params(get_config(arch)))).items()},
                    {k: JS.drop_data(JS.param_spec(jm, k.split("/"), v))
                     for k, v in jp.items()})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax_for_every_leaf(arch):
    B, M = 128, 32768
    jc = _jleaves(j_abstract_cache(jget_config(arch), B, M))
    tc = _tleaves(abstract_cache(get_config(arch), B, M))
    assert set(tc) == set(jc)
    cfg_t, cfg_j = get_config(arch), jget_config(arch)
    for name, (tm, jm) in MESHES.items():
        for k in jc:
            assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        _same_specs({k: TS.cache_spec(tm, cfg_t, k, v) for k, v in tc.items()},
                    {k: JS.cache_spec(jm, cfg_j, k.split("/"), v)
                     for k, v in jc.items()})
        # batch 1 (long_500k) cannot shard the batch dim
        one_t = _tleaves(abstract_cache(cfg_t, 1, 64))
        one_j = _jleaves(j_abstract_cache(cfg_j, 1, 64))
        _same_specs({k: TS.cache_spec(tm, cfg_t, k, v)
                     for k, v in one_t.items()},
                    {k: JS.cache_spec(jm, cfg_j, k.split("/"), v)
                     for k, v in one_j.items()})


def test_opt_shardings_mirror_params_as_jax():
    cfg = "moonshot-v1-16b-a3b"
    tparams = abstract_params(get_config(cfg))
    jparams = j_abstract_params(jget_config(cfg))
    for tm, jm in MESHES.values():
        t = TS.opt_shardings(tm, adamw_init(tparams), tparams)
        j = JS.opt_shardings(jm, jax.eval_shape(j_adamw_init, jparams),
                             jparams)
        assert tuple(t.step.spec) == tuple(j.step.spec) == ()
        tm_, jm_ = ({k: s.spec for k, s in _tleaves(x).items()}
                    for x in (t.m, t.v))
        jmm = {k: s.spec for k, s in _jleaves(j.m).items()}
        _same_specs(tm_, jmm)
        _same_specs(jm_, jmm)


@pytest.mark.parametrize("spec", [
    ("data", "model", None), (("pod", "data"), None), ("data",),
    (None, ("data", "model")), (("pod", "data", "model"), "stage"), ()])
def test_drop_data_guard_batch_and_act_specs_match_jax(spec):
    import pickle

    from jax.sharding import PartitionSpec as JP
    assert tuple(TS.drop_data(TS.P(*spec))) == tuple(JS.drop_data(JP(*spec)))
    assert tuple(TS.P(*spec)) == tuple(JP(*spec))
    # a spec crosses to the ranks pickled, entry by entry
    assert pickle.loads(pickle.dumps(TS.P(*spec))) == TS.P(*spec)
    for tm, jm in MESHES.values():
        assert tuple(TS.batch_spec(tm)) == tuple(JS.batch_spec(jm))
        assert tuple(TS.act_spec(tm)) == tuple(JS.act_spec(jm))
        for shape in [(32, 48, 7), (2, 16, 64), (256, 4096, 3840),
                      (1, 1, 1)]:
            want = spec + (None,) * (len(shape) - len(spec))
            if len(want) > len(shape):
                continue
            assert (tuple(TS.guard_spec(tm, TS.P(*spec), shape))
                    == tuple(JS.guard_spec(jm, JP(*spec), shape)))


@pytest.mark.parametrize("mesh,n_tokens,n_experts", [
    ("16x16", 8192, 64), ("16x16", 1024, 64), ("2x16x16", 65536, 128),
    ("2x16x16", 4096, 8), ("16x4x4", 2048, 8), ("16x4x4", 100, 2),
    (None, 8192, 64)])
def test_moe_groups_read_the_registered_layout_as_jax(mesh, n_tokens,
                                                      n_experts):
    tm, jm = MESHES[mesh] if mesh else (None, None)
    try:
        JL.set_attention_mesh(jm)
        TL.set_attention_mesh(tm)
        assert (TM.moe_groups(n_tokens, n_experts)
                == JM.moe_groups(n_tokens, n_experts))
    finally:
        JL.set_attention_mesh(None)
        TL.set_attention_mesh(None)


def test_moe_apply_routes_in_the_layouts_groups_as_jax():
    """A (2, 2) layout routes the sort path in 2 groups, each with its own
    capacity (so the dropped set changes); JAX given n_groups=2 agrees."""
    rng = np.random.default_rng(3)
    d, ff, E, k = 16, 32, 4, 2
    w = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.5,
         "wi": rng.standard_normal((E, d, 2, ff)).astype(np.float32) * 0.25,
         "wo": rng.standard_normal((E, ff, d)).astype(np.float32) * 0.2}
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    tw = {n: torch.from_numpy(v) for n, v in w.items()}
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    layout = TMESH.MeshLayout((2, 2), ("data", "model"))
    try:
        TL.set_attention_mesh(layout)
        route = {}
        ty, taux = TM.moe_apply(tw, torch.from_numpy(x), k, 1.0,
                                mode="sort", routing=route)
    finally:
        TL.set_attention_mesh(None)
    assert route["G"] == 2
    ty1, taux1 = TM.moe_apply(tw, torch.from_numpy(x), k, 1.0, mode="sort")
    jy, jaux = JM.moe_apply(jw, jnp.asarray(x), k, 1.0, n_groups=2,
                            mode="sort")
    ref = np.asarray(jy)
    scale = np.abs(ref).max()
    assert np.abs(ty.numpy() - ref).max() <= 2e-4 * scale
    for key in ("load_balance_loss", "router_z_loss", "dropped_frac"):
        assert abs(float(taux[key]) - float(jaux[key])) <= 1e-5, key
    # one group (no layout) drops another set: the layout decides
    assert not torch.allclose(ty, ty1, atol=1e-4)
    assert float(taux["dropped_frac"]) != float(taux1["dropped_frac"])


def test_dtensor_placements_con_heads_and_inventory_on_a_2x2_gloo_mesh():
    layout = TMESH.MeshLayout((2, 2), ("data", "model"))
    cfg = get_config("gemma3-12b").reduced(n_layers=2)
    g = torch.Generator().manual_seed(0)
    from repro_torch.models import LM
    params = _tleaves(LM(cfg).init(g))
    specs = {k: TS.param_spec(layout, k, v) for k, v in params.items()}
    assert any(len([e for e in s if e]) == 2 for s in specs.values())
    x = torch.randn((2, 5, 4, 8), generator=g)
    res = TMESH.run_on_local_mesh((2, 2), ("data", "model"), placement_rank,
                                  params, specs, x, device="cpu", timeout=120)
    for r in res:
        for k, v in params.items():
            want = TS.local_shape(layout, specs[k], tuple(v.shape))
            assert r["local"][k]["shape"] == want, k
            assert r["local"][k]["whole"], k
        heads = TL.heads_spec(layout, tuple(x.shape))
        assert heads == ("data", None, "model", None)
        assert r["heads"]["shape"] == (1, 5, 2, 8)
        assert r["heads"]["placements"] == ["S(0)", "S(2)"]
        assert r["heads"]["whole"] and r["heads"]["plain_unchanged"]
        assert [c for _, _, c, _ in r["inventory"]] == r["ndindex"]
        assert [(o, d) for o, d, _, _ in r["inventory"]] == [
            (i, i) for i in range(4)]
        assert {p for *_, p in r["inventory"]} == {"cpu"}
