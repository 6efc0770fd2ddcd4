"""Tensor-parallel training across ranks on the CPU, held against the JAX
package.

The port's train step on DTensor state (``init_train_state_sharded``:
params by ``param_shardings``, moments by ``opt_shardings``) on ``(1,
model)`` gloo meshes of ``run_on_local_mesh``, against the JAX package's
unsharded ``loss_fn`` under ``jax.value_and_grad`` and its
``make_train_step(cfg, None)`` on the same weights and batches (GSPMD
changes no value), at a reduced f32 gemma3 (4 layers, 4 heads over 2 kv
heads, window 8, vocab 250 padded to 256 rows, so the last rank's rows
beyond the vocab are masked), B 2 x S 16, loss chunk 8 (two chunks):

* model 2: every sharded dim divides; model 4: ``n_kv_heads`` 2 does not,
  so the guard leaves ``wk``/``wv`` whole on every rank, each reading its
  heads' kv heads; each with ``seq_parallel`` on (the carry [B, S/m, d]
  between layers, the norms on each rank's tokens) and off, and on 4
  ranks with ``seq_parallel`` over 18 tokens (the guard leaves S whole);
* the loss (rtol 1e-5) and every gradient leaf, reassembled from the
  ranks' shards, within 2e-4 of max |reference| (f32: the products split
  in other orders, as ``tests/test_torch_train.py`` holds the unsharded
  step); every gradient a DTensor laid out as its param;
* two ``make_train_step`` steps: the loss and grad_norm (rtol 1e-4, the
  grad_norm equal on every rank), both moments within 1e-4 of max
  |reference|, the params too where the first gradient fixes the sign of
  AdamW's first update (:func:`_param_err`); each moment's local shape is
  ``local_shape`` of its ``opt_shardings`` spec; a whole optimizer state
  through ``distribute_params`` keeps each rank's shards;
* the replicated-leaf rule: a leaf every rank holds whole has its gradient
  summed over the model axis exactly when the ranks split its use (the
  norm scales under ``seq_parallel``, the guard's ``wk``/``wv``), each
  rank's copy held to the JAX gradient — a part, or m times it, fails;
* musicgen-large (the audio family: the dense backbone over given
  embeddings) served and trained on a (1, 2) mesh;
* gemma3 reduced to 3 heads over 1 kv head on 2 ranks: the heads stay
  whole on every rank while ``attn/wo``'s rows split (one head cut), so
  each rank's use of ``x``, ``wq``, ``wk`` and ``wv`` is a part and their
  gradients are summed; loss and every gradient against ``jax.grad``,
  ``seq_parallel`` on and off;
* every family's train step on a data axis of 2 (the moe and vlm params
  and moments take their local shapes), and the train step at
  ``scan_chunks`` 2 equal to its step at 0 bit for bit;
* plain tensors (one process) take today's path, bit for bit, with a
  layout registered or not;
* ``models/``, ``core/`` and ``kernels/`` import nothing from ``launch/``.

Three spawns in all, each with a deadline.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as JST
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.launch import steps as TST
from repro_torch.models import layers as TL
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import adamw_init

from torch_spmd_ranks import tp_refusal_rank, tp_train_rank

torch.set_num_threads(1)

B, S, CHUNK, N_DEC = 2, 16, 8, 3
S_ODD = 18                  # not divided by a model axis of 4
KW = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=CHUNK)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _paths(tree) -> dict:
    """path → leaf of a port tree."""
    out = {}
    TS.map_with_path(lambda p, a: out.__setitem__(TS.path_str(p), a), tree)
    return out


def _port_paths(jtree) -> dict:
    """path → f32 tensor of a JAX tree."""
    return _paths(params_from_numpy(jax.tree.map(np.asarray, jtree),
                                    "float32", device="cpu"))


def _err(got, want) -> float:
    want = torch.as_tensor(np.array(want, np.float32))
    got = torch.as_tensor(got).float()
    assert got.shape == want.shape
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _param_err(got, want, g1) -> float:
    """:func:`_err` of the params after the steps, over the elements whose
    first-step gradient ``g1`` (JAX's) the gradient test fixes: |g1| above
    2e-4 of its leaf's largest.  Below that AdamW's first update,
    g / (|g| + 1e-8), takes its sign from the f32 noise of a sum that
    cancels (the unsharded port's own two steps move one mlp/wi weight
    1.19e-4 of max|w| off JAX's here); the moments, linear and quadratic
    in the gradients, are held over every element."""
    keep = g1.abs() > 2e-4 * g1.abs().max()
    want = torch.as_tensor(np.array(want, np.float32))
    assert got.shape == want.shape
    return float((got.float() - want).abs()[keep].max()
                 / want.abs().max().clamp_min(1e-30))


def _whole(res: list, key) -> dict:
    """path → the leaf reassembled from every rank's ``key(r)`` shards
    (path → (local, bounds, shape)); ranks holding a leaf whole agree."""
    out = {}
    for path, (_, _, shape) in key(res[0]).items():
        full = torch.zeros(shape)
        for r in res:
            local, bounds, _ = key(r)[path]
            if all(b.stop - b.start == n for b, n in zip(bounds, shape)):
                assert torch.equal(local, key(res[0])[path][0]), path
            full[bounds] = local
        out[path] = full
    return out


def _jax_batch(ids, labels, mask) -> dict:
    return {"ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
            "mask": jnp.asarray(mask)}


@pytest.fixture(scope="module")
def reference():
    """The JAX runs: the loss and gradients on one batch, two train steps,
    and musicgen-large's serve steps and gradients."""
    jc = jget_config("gemma3-12b").reduced(vocab=250)
    cfg = get_config("gemma3-12b").reduced(vocab=250)
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(29)
    draws = [(rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              (rng.random((B, S)) < 0.8).astype(np.float32))
             for _ in range(2)]
    ids, labels, mask = draws[0]

    def loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(ids), remat=True)
        return jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                       chunk=CHUNK)

    loss, grads = jax.value_and_grad(loss_fn)(jp)
    odd = [rng.integers(0, jc.vocab, (B, S_ODD)).astype(np.int32),
           rng.integers(0, jc.vocab, (B, S_ODD)).astype(np.int32),
           (rng.random((B, S_ODD)) < 0.8).astype(np.float32)]

    def odd_loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(odd[0]), remat=True)
        return jm.loss(p, h, jnp.asarray(odd[1]), jnp.asarray(odd[2]),
                       chunk=CHUNK)

    odd_loss, odd_grads = jax.value_and_grad(odd_loss_fn)(jp)
    _, jstep = JST.make_train_step(jc, None, seq_parallel=False, **KW)
    jstep = jax.jit(jstep)
    state, metrics = {"params": jp, "opt": j_adamw_init(jp)}, []
    for d in draws:
        state, met = jstep(state, _jax_batch(*d))
        metrics.append({k: float(v) for k, v in met.items()})
    batches = [{"ids": torch.from_numpy(i).long(),
                "labels": torch.from_numpy(lb), "mask": torch.from_numpy(m)}
               for i, lb, m in draws]
    return {"cfg": cfg, "layout": lambda m: TMESH.MeshLayout(
                (1, m), ("data", "model")),
            "whole_heads": _whole_heads_reference(draws[0]),
            "params": params_from_numpy(jax.tree.map(np.asarray, jp),
                                        cfg.dtype, device="cpu"),
            "batches": batches, "loss": float(loss),
            "grads": _port_paths(grads), "metrics": metrics,
            "odd": {"batch": {"ids": torch.from_numpy(odd[0]).long(),
                              "labels": torch.from_numpy(odd[1]),
                              "mask": torch.from_numpy(odd[2])},
                    "loss": float(odd_loss),
                    "grads": _port_paths(odd_grads)},
            "after": {k: _port_paths(v) for k, v in
                      (("params", state["params"]),
                       ("m", state["opt"].m), ("v", state["opt"].v))},
            "audio": _audio_reference()}


def _whole_heads_reference(draw) -> dict:
    """gemma3 reduced to 3 heads over 1 kv head: on 2 ranks the heads stay
    whole (3 does not divide 2) while ``attn/wo``'s 48 rows split, cutting
    head 1; JAX's loss and gradients on ``draw``."""
    over = dict(vocab=250, n_heads=3, n_kv_heads=1)
    jc = jget_config("gemma3-12b").reduced(**over)
    cfg = get_config("gemma3-12b").reduced(**over)
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(4))
    ids, labels, mask = draw

    def loss_fn(p):
        h, _ = jm.apply(p, jnp.asarray(ids), remat=True)
        return jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                       chunk=CHUNK)

    loss, grads = jax.value_and_grad(loss_fn)(jp)
    return {"cfg": cfg, "params": params_from_numpy(
                jax.tree.map(np.asarray, jp), cfg.dtype, device="cpu"),
            "loss": float(loss), "grads": _port_paths(grads)}


def _audio_reference() -> dict:
    """musicgen-large reduced: the JAX prefill step's logits, LM.prefill,
    N_DEC decode steps on drawn embeddings, and the loss and gradients."""
    jc = jget_config("musicgen-large").reduced()
    cfg = get_config("musicgen-large").reduced()
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(30)
    emb = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    steps = rng.standard_normal((B, N_DEC, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    _, jpre = JST.make_prefill_step(jc)
    logits = np.asarray(jpre(jp, {"embeds": jnp.asarray(emb)}))
    cache = jm.init_cache(B, S + N_DEC)
    _, cache = jm.prefill(jp, None, cache, embeds=jnp.asarray(emb))
    _, jdec = JST.make_decode_step(jc)
    dec = []
    for j in range(N_DEC):
        lg, cache = jdec(jp, cache, {"embeds": jnp.asarray(steps[:, j:j + 1]),
                                     "pos": S + j})
        dec.append(np.asarray(lg))

    def loss_fn(p):
        h, _ = jm.apply(p, None, embeds=jnp.asarray(emb), remat=True)
        return jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                       chunk=CHUNK)

    loss, grads = jax.value_and_grad(loss_fn)(jp)
    batch = {"embeds": torch.from_numpy(emb),
             "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask)}
    return {"cfg": cfg, "params": params_from_numpy(
                jax.tree.map(np.asarray, jp), cfg.dtype, device="cpu"),
            "embeds": torch.from_numpy(emb), "steps": torch.from_numpy(steps),
            "batch": batch, "logits": logits, "decode": dec,
            "loss": float(loss), "grads": _port_paths(grads)}


_RUNS: dict = {}


def _ranks(ref, model: int) -> list:
    """The ranks' results on a (1, model) mesh (one spawn a mesh); the
    (1, 2) run also serves and trains musicgen-large, the (1, 4) run
    trains on S_ODD tokens; the (1, 2) run also takes the gradients of
    the whole-heads config (:func:`_whole_heads_reference`)."""
    if model not in _RUNS:
        a, wh = ref["audio"], ref["whole_heads"]
        audio = ((a["cfg"], a["params"], a["embeds"], a["steps"], a["batch"])
                 if model == 2 else None)
        odd = ref["odd"]["batch"] if model == 4 else None
        heads = ((wh["cfg"], wh["params"], ref["batches"][0])
                 if model == 2 else None)
        _RUNS[model] = TMESH.run_on_local_mesh(
            (1, model), ("data", "model"), tp_train_rank, ref["cfg"],
            ref["params"], ref["batches"][0], ref["batches"], KW, audio,
            odd, heads, device="cpu", timeout=300)
    return _RUNS[model]


CASES = [(2, True), (2, False), (4, True), (4, False)]
IDS = [f"model{m}-{'seq' if sp else 'noseq'}" for m, sp in CASES]
# the same cases, then the whole-heads config on 2 ranks (its heads whole,
# attn/wo's rows split), seq_parallel on and off
GRAD_CASES = [(m, sp, False) for m, sp in CASES] + [
    (2, True, True), (2, False, True)]
GRAD_IDS = IDS + ["model2-seq-whole-heads", "model2-noseq-whole-heads"]


@pytest.mark.parametrize("model,sp,whole_heads", GRAD_CASES, ids=GRAD_IDS)
def test_tp_loss_and_gradients_match_jax_unsharded(reference, model, sp,
                                                   whole_heads):
    """The loss and every gradient leaf against ``jax.value_and_grad``;
    in the whole-heads cases each rank reads every head but only its rows
    of ``attn/wo``, so the gradients of ``x``, ``wq``, ``wk`` and ``wv`` are
    a part on each rank until summed over the model axis."""
    ref = reference["whole_heads"] if whole_heads else reference
    res = _ranks(reference, model)
    if whole_heads:
        res = [r["whole_heads"] for r in res]
    for r in res:
        np.testing.assert_allclose(r["loss"][sp], ref["loss"], rtol=1e-5)
        assert r["laid_out"][sp]
    got = _whole(res, lambda r: r["grads"][sp])
    assert set(got) == set(ref["grads"])
    errs = {p: _err(got[p], ref["grads"][p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs


@pytest.mark.parametrize("model,sp", CASES, ids=IDS)
def test_tp_two_train_steps_match_jax(reference, model, sp):
    ref = reference
    res = _ranks(ref, model)
    layout = ref["layout"](model)
    specs = _paths(TS.opt_shardings(layout, adamw_init(ref["params"]),
                                    ref["params"]).m)
    for r in res:
        assert r["opt_distributed"]
        st = r["steps"][sp]
        assert st["step"] == 2 and st["step_plain"]
        assert st["moments_laid_out"]
        for got, want in zip(st["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        for name in ("m", "v"):
            for path, (local, _, shape) in st[name].items():
                assert tuple(local.shape) == TS.local_shape(
                    layout, specs[path].spec, shape), (name, path)
    for i in range(2):          # one number on every rank
        norms = {r["steps"][sp]["metrics"][i]["grad_norm"] for r in res}
        assert len(norms) == 1, norms
    got = _whole(res, lambda r: r["steps"][sp]["params"])
    errs = {p: _param_err(got[p], ref["after"]["params"][p],
                          ref["grads"][p]) for p in got}
    assert max(errs.values()) <= 1e-4, errs
    for name in ("m", "v"):
        got = _whole(res, lambda r: r["steps"][sp][name])
        errs = {p: _err(got[p], ref["after"][name][p]) for p in got}
        assert max(errs.values()) <= 1e-4, (name, errs)


@pytest.mark.parametrize("model", [2, 4])
def test_replicated_leaf_gradient_is_summed_exactly_when_its_use_is_split(
        reference, model):
    """Each rank's copy of a leaf every rank holds whole is the JAX
    gradient: the norm scales (their use split by the tokens under
    seq_parallel, whole without) and, under the guard (model 4), ``wk``
    and ``wv`` (each rank reading its heads' kv heads).  A gradient left
    as its rank's part, or summed where every rank's use was whole, is off
    by a factor; so is the rule's own case, a 3-element leaf each rank
    weights by its rank + 1."""
    ref = reference
    res = _ranks(ref, model)
    whole = ["layers/ln1/scale", "layers/ln2/scale", "final_norm/scale"]
    if model == 4:
        whole += ["layers/attn/wk", "layers/attn/wv"]
    for r in res:
        for sp in (True, False):
            for path in whole:
                local, bounds, shape = r["grads"][sp][path]
                assert tuple(local.shape) == shape, path    # held whole
                err = _err(local, ref["grads"][path])
                assert err <= 2e-4, (r["rule"], sp, path, err)
        total = model * (model + 1) / 2
        assert r["rule"][True].tolist() == [total] * 3
    assert [r["rule"][False].tolist() for r in res] == [
        [float(i + 1)] * 3 for i in range(model)]


def test_tp_carry_stays_whole_where_the_model_axis_does_not_divide_s(
        reference):
    """seq_parallel over 18 tokens on 4 ranks: the guard leaves S whole,
    and the loss and gradients are JAX's as on the split carry."""
    odd = reference["odd"]
    res = _ranks(reference, 4)
    for r in res:
        loss, _, laid_out = r["odd"]
        np.testing.assert_allclose(loss, odd["loss"], rtol=1e-5)
        assert laid_out
    got = _whole(res, lambda r: r["odd"][1])
    errs = {p: _err(got[p], odd["grads"][p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs


def test_audio_family_serves_and_trains_under_the_model_axis(reference):
    a = reference["audio"]
    for r in _ranks(reference, 2):
        got = r["audio"]
        assert _err(got["logits"], a["logits"]) <= 2e-4
        for g, w in zip(got["decode"], a["decode"]):
            assert _err(g, w) <= 2e-4
        np.testing.assert_allclose(got["loss"], a["loss"], rtol=1e-5)
        assert got["laid_out"]
    grads = _whole(_ranks(reference, 2), lambda r: r["audio"]["grads"])
    errs = {p: _err(grads[p], a["grads"][p]) for p in grads}
    assert max(errs.values()) <= 2e-4, errs


def test_train_step_runs_scan_chunks_and_every_family_on_data(reference):
    """``scan_chunks`` 2 under sharded weights: the train step equals its
    step at 0 bit for bit (the metrics, params and moments) on both
    ranks.  The dense, moe, ssm (rwkv), hybrid (hymba) and vlm families'
    train steps run on a data axis over two ranks
    (``tests/test_torch_fsdp.py``, ``tests/test_torch_fsdp_vlm.py``: here
    the batch is whole on every rank).  On
    the (data 2, model 2) mesh the moe and vlm families' params and
    moments are at their ``param_shardings`` local shapes (the experts
    split over model, d over data, the router whole; the vlm self layers'
    [G, per, d, H, hd] with d over data and the heads over model)."""
    moe = get_config("moonshot-v1-16b-a3b").reduced()
    families = [get_config(a).reduced() for a in (
        "rwkv6-1.6b", "hymba-1.5b", "llama-3.2-vision-11b")]
    assert [c.family for c in families] == ["ssm", "hybrid", "vlm"]
    ids = {"ids": torch.zeros((4, 8), dtype=torch.long),
           "labels": torch.zeros((4, 8), dtype=torch.int32),
           "mask": torch.ones((4, 8))}
    res = TMESH.run_on_local_mesh((2, 2), ("data", "model"),
                                  tp_refusal_rank, [moe, *families],
                                  reference["cfg"], 7, ids, device="cpu",
                                  timeout=240)
    layout = TMESH.MeshLayout((2, 2), ("data", "model"))

    def local_shapes(c) -> dict:
        whole = TST.abstract_params(c)
        specs = _paths(TS.param_shardings(layout, whole))
        return {f"{n}/{p}": TS.local_shape(layout, specs[p].spec,
                                           tuple(a.shape))
                for p, a in _paths(whole).items()
                for n in ("params", "m", "v")}

    vlm = families[-1]
    want, want_vlm = local_shapes(moe), local_shapes(vlm)
    L, E, d, ff = moe.n_layers, moe.n_experts, moe.d_model, moe.d_ff
    for r in res:
        for c in families:
            assert r[c.arch_id] == "", (c.arch_id, r[c.arch_id])
        assert r[reference["cfg"].arch_id] == ""
        assert r[moe.arch_id] == "", r[moe.arch_id]
        assert r["shapes"][moe.arch_id] == want
        assert r["shapes"][vlm.arch_id] == want_vlm
        for n in ("params", "m", "v"):
            got = r["shapes"][vlm.arch_id]
            assert got[f"{n}/layers/attn/wq"] == (
                2, 1, vlm.d_model // 2, vlm.n_heads // 2, vlm.hd)
            assert got[f"{n}/cross/attn/wo"] == (
                2, vlm.n_heads * vlm.hd // 2, vlm.d_model // 2)
        for n in ("params", "m", "v"):
            got = r["shapes"][moe.arch_id]
            assert got[f"{n}/layers/moe/wi"] == (L, E // 2, d // 2, 2, ff)
            assert got[f"{n}/layers/moe/wo"] == (L, E // 2, ff // 2, d)
            assert got[f"{n}/layers/moe/router"] == (L, d, E)
    for r in _ranks(reference, 2):
        equal, loss = r["scan"]
        assert equal and np.isfinite(loss)


def test_plain_tensor_train_step_is_unchanged_by_a_layout(reference):
    """One process holding the model whole: two steps with a (1, 2) layout
    registered (seq_parallel on) give the same bits as with none, and the
    JAX steps' params."""
    ref = reference
    cfg = ref["cfg"]
    out = []
    try:
        for mesh in (None, ref["layout"](2)):
            params = tree_map(lambda a: a.clone(), ref["params"])
            state = {"params": params, "opt": adamw_init(params)}
            _, step = TST.make_train_step(cfg, mesh, **KW)
            mets = []
            for b in ref["batches"]:
                state, met = step(state, b)
                mets.append(met)
            out.append((state, mets))
            TL.set_attention_mesh(None)
    finally:
        TL.set_attention_mesh(None)
    (s0, m0), (s1, m1) = out
    for a, b in zip(leaves(s0), leaves(s1)):
        assert torch.equal(a, b)
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    got = _paths(s0["params"])
    errs = {p: _param_err(got[p], ref["after"]["params"][p],
                          ref["grads"][p]) for p in got}
    assert max(errs.values()) <= 1e-4, errs


def _imports(path: pathlib.Path) -> list:
    """The absolute module names ``path`` (a module of repro_torch)
    imports, relative imports resolved."""
    pkg = list(path.relative_to(SRC.parent).parts[:-1])
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = (pkg[:len(pkg) - node.level + 1] if node.level
                    else [])
            mod = ".".join(base + ([node.module] if node.module else []))
            names.append(mod)
            names += [f"{mod}.{a.name}" for a in node.names]
    return names


def test_models_core_and_kernels_import_nothing_from_launch():
    """The layers below the launcher reach it through nothing: no module
    of ``core/``, ``models/`` or ``kernels/`` imports ``repro_torch.launch``
    (the rank mesh and ``with_spec`` live in ``core``)."""
    found = []
    for sub in ("core", "models", "kernels"):
        for path in sorted((SRC / sub).rglob("*.py")):
            for name in _imports(path):
                if name == "repro_torch.launch" or name.startswith(
                        "repro_torch.launch."):
                    found.append((str(path.relative_to(SRC)), name))
    assert not found, found
    # the resolver sees the launcher's own imports of core
    assert "repro_torch.core.spmd_pipeline.set_current_mesh" in _imports(
        SRC / "launch" / "mesh.py")
