"""Tensor-parallel LM serving across ranks on the CPU, held against the JAX
package.

The port's serve steps on weights laid out by ``param_shardings_serving``
(DTensors, each rank holding its shard) and a cache by
``cache_shardings``, on ``(1, model)`` gloo meshes of
``run_on_local_mesh``, against the JAX package's ``make_prefill_step`` /
``make_decode_step`` with no mesh (GSPMD changes no value) on the same
weights, at a reduced f32 gemma3 (4 layers, window 8 under a 12-token
prompt, 4 heads over 2 kv heads):

* model 2: every sharded dim divides; model 4: ``n_kv_heads`` 2 does not,
  so the guard leaves ``wk``/``wv`` replicated and shards the cache's
  head_dim (gathered to decode);
* the prefill step's logits, 3 teacher-forced decode steps' logits and
  the cache, reassembled from the ranks' shards, within 2e-4 of max
  |reference| (f32, as ``tests/test_kernels.py``: the products split in
  other orders);
* each leaf's local shape is ``local_shape`` of its spec;
* ``distribute_params`` keeps of each leaf the whole draw at the rank's
  ``local_bounds``, and ``init_cache_sharded`` allocates only the shards,
  for a dense and a moe config (``tests/test_torch_ep.py`` serves the moe
  family); a data axis of 2 and a DTensor handed to K7 (whose plain
  version must not take it) are refused;
* plain tensors (one process) take today's path, bit for bit, with a
  layout registered or not.

Three spawns in all, each with a deadline.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as JST
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro_torch.configs import get_config
from repro_torch.core.spmd_pipeline import is_dtensor
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models import layers as TL
from repro_torch.models.transformer import params_from_numpy

from torch_spmd_ranks import tp_init_rank, tp_serve_rank

torch.set_num_threads(1)

B, S, N = 2, 12, 3


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-4 * max(np.abs(want).max(), 1e-6)


@pytest.fixture(scope="module")
def reference():
    """The JAX run (weights, prompts, decode tokens, logits, cache)."""
    jcfg = jget_config("gemma3-12b").reduced()
    jm = JLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(28)
    ids = rng.integers(0, jcfg.vocab, (B, S))
    steps = rng.integers(0, jcfg.vocab, (B, N))
    _, jpre = JST.make_prefill_step(jcfg)
    logits = np.asarray(jpre(jparams, {"ids": jnp.asarray(ids)}))
    jcache = jm.init_cache(B, S + N)
    _, jcache = jm.prefill(jparams, jnp.asarray(ids), jcache)
    _, jdec = JST.make_decode_step(jcfg)
    jdec = jax.jit(jdec)
    dec = []
    for j in range(N):
        lg, jcache = jdec(jparams, jcache,
                          {"ids": jnp.asarray(steps[:, j:j + 1]),
                           "pos": S + j})
        dec.append(np.asarray(lg))
    cfg = get_config("gemma3-12b").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg.dtype,
                               device="cpu")
    return {"cfg": cfg, "params": params, "ids": torch.from_numpy(ids),
            "steps": torch.from_numpy(steps), "logits": logits,
            "decode": dec, "cache": {k: np.asarray(jcache[k])
                                     for k in ("k", "v")}}


@pytest.mark.parametrize("model", [2, 4])
def test_tensor_parallel_steps_match_jax_unsharded(reference, model):
    ref = reference
    cfg = ref["cfg"]
    res = TMESH.run_on_local_mesh((1, model), ("data", "model"),
                                  tp_serve_rank, cfg, ref["params"],
                                  ref["ids"], ref["steps"], device="cpu",
                                  timeout=240)
    layout = TMESH.MeshLayout((1, model), ("data", "model"))
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     tuple(sh.spec)),
                     TS.param_shardings_serving(layout, ref["params"]))
    for r in res:
        assert r["all_dtensors"]
        assert r["specs"] == specs
        for path, (local, whole) in r["shapes"].items():
            assert local == TS.local_shape(layout, specs[path], whole), path
        _close(r["logits"], ref["logits"])
        for got, want in zip(r["decode"], ref["decode"]):
            _close(got, want)
    # half (or a quarter) of the heads, ff columns and vocab rows a rank
    shapes = res[0]["shapes"]
    assert shapes["layers/attn/wq"][0][2] == cfg.n_heads // model
    assert shapes["layers/mlp/wi"][0][3] == cfg.d_ff // model
    assert shapes["embed/table"][0][0] == cfg.vocab_padded // model
    kv_split = cfg.n_kv_heads % model == 0
    assert shapes["layers/attn/wk"][0][2] == (
        cfg.n_kv_heads // model if kv_split else cfg.n_kv_heads)
    for name in ("k", "v"):
        full = torch.zeros(res[0]["cache"][name][2])
        seen = torch.zeros(res[0]["cache"][name][2], dtype=torch.bool)
        for r in res:
            local, bounds, _ = r["cache"][name]
            if kv_split:                       # kv heads over the model axis
                assert local.shape[3] == cfg.n_kv_heads // model
            else:                              # the guard: head_dim instead
                assert local.shape[3:] == (cfg.n_kv_heads, cfg.hd // model)
            full[bounds] = local
            seen[bounds] = True
        assert bool(seen.all())
        _close(full, ref["cache"][name])


def test_sharded_init_and_cache_and_what_is_refused():
    """On a (data 2, model 2) mesh: each rank's shards are the whole draw
    at its bounds, the sharded cache holds zeros of the local shapes, for
    a dense and a moe config (the experts half a rank, the router whole);
    a data axis of 2 is refused for both."""
    cfg = get_config("gemma3-12b").reduced()
    moe = get_config("moonshot-v1-16b-a3b").reduced()
    res = TMESH.run_on_local_mesh((2, 2), ("data", "model"), tp_init_rank,
                                  cfg, moe, 5, device="cpu", timeout=240)
    layout = TMESH.MeshLayout((2, 2), ("data", "model"))

    def cache_specs(c):
        out = {}
        whole = TST.abstract_cache(c, 4, 16)
        TS.map_with_path(lambda p, sh: out.__setitem__(
            TS.path_str(p), (tuple(sh.spec), tuple(whole[p[-1]].shape))),
            TS.cache_shardings(layout, c, whole))
        return out

    specs = {c.arch_id: cache_specs(c) for c in (cfg, moe)}
    moe_whole = TST.abstract_params(moe)
    moe_specs = {}
    TS.map_with_path(lambda p, sh: moe_specs.__setitem__(
        TS.path_str(p), tuple(sh.spec)),
        TS.param_shardings_serving(layout, moe_whole))
    moe_shapes = {}
    TS.map_with_path(lambda p, a: moe_shapes.__setitem__(
        TS.path_str(p), tuple(a.shape)), moe_whole)
    for r in res:
        assert r["shards_of_whole_draw"]
        for c, key in ((cfg, "cache_shapes"), (moe, "moe_cache_shapes")):
            assert set(r[key]) == set(specs[c.arch_id])
            for path, local in r[key].items():
                spec, shape = specs[c.arch_id][path]
                assert local == TS.local_shape(layout, spec, shape)
        assert set(r["moe_shapes"]) == set(moe_specs)
        for path, local in r["moe_shapes"].items():
            assert local == TS.local_shape(layout, moe_specs[path],
                                           moe_shapes[path]), path
        L, E = moe.n_layers, moe.n_experts
        assert r["moe_shapes"]["layers/moe/wi"] == (
            L, E // 2, moe.d_model, 2, moe.d_ff)
        assert r["moe_shapes"]["layers/moe/wo"] == (
            L, E // 2, moe.d_ff, moe.d_model)
        assert r["moe_shapes"]["layers/moe/router"] == (L, moe.d_model, E)
        assert r["cache_zero"]
        assert "(1, model) mesh" in r["data_refused"]
        assert "(1, model) mesh" in r["moe_data_refused"]
        assert "got a DTensor" in r["dtensor_kernel"]


def test_plain_tensor_serving_is_unchanged_by_a_layout(reference):
    """One process holding the model whole: the steps with a (1, 2) layout
    registered give the same bits as with none."""
    ref = reference
    cfg, params = ref["cfg"], ref["params"]
    layout = TMESH.MeshLayout((1, 2), ("data", "model"))
    out = []
    try:
        for mesh in (None, layout):
            model, pre = TST.make_prefill_step(cfg, mesh)
            _, dec = TST.make_decode_step(cfg, mesh)
            logits = pre(params, {"ids": ref["ids"]})
            cache = model.init_cache(B, S + N, device="cpu")
            model.prefill(params, ref["ids"], cache)
            decs = [dec(params, cache, {"ids": ref["steps"][:, j:j + 1],
                                        "pos": S + j})[0] for j in range(N)]
            out.append((logits, decs, cache))
            TL.set_attention_mesh(None)
    finally:
        TL.set_attention_mesh(None)
    (l0, d0, c0), (l1, d1, c1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(d0, d1))
    assert all(torch.equal(c0[k], c1[k]) for k in ("k", "v"))
    assert not is_dtensor(params["embed"]["table"])
    _close(l0, ref["logits"])
