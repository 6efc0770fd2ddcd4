"""Expert parallelism across ranks on the CPU, held against the JAX package.

The moe family on ``(1, model)`` gloo meshes of ``run_on_local_mesh``:
weights as DTensors (``moe/wi`` [E, d, 2, ff] and ``moe/wo`` [E, ff, d]
with E over the model axis, the router whole on every rank), each rank
computing its E/m experts, against the JAX package's unsharded functions
(GSPMD changes no value) on the same numpy weights, at a reduced f32
moonshot-v1-16b-a3b (4 layers, d 64, 4 heads over 2 kv heads, 4 experts,
top 2, vocab 256), B 2 x S 16 (the sort dispatch: 32 tokens make no 16
groups of 512), loss chunk 8:

* ``moe_apply`` with ``mode="sort"`` and with ``mode="einsum"`` (4
  groups), capacity factor 1.0 (drops), on 2 and 4 ranks (2 and 1
  experts a rank): the output within 2e-4 of max |reference|, the aux
  losses (rtol 1e-5) and ``dropped_frac`` exactly, and the gradient of
  sum(y²) for x, the router, ``wi`` and ``wo`` against ``jax.vjp``'s
  (2e-4 of max |reference|);
* the prefill step's logits, ``LM.prefill``'s cache and three
  teacher-forced decode steps' logits on 2 ranks (2e-4 of max
  |reference|), and every leaf's local shape;
* the gradient of the train loss (cross-entropy + 1e-2 load balance +
  1e-3 router z), every leaf reassembled, with ``seq_parallel`` on and off
  on 2 and 4 ranks (loss rtol 1e-5, gradients 2e-4 of max |reference|);
  and, as the two uses of the router and of the norm before it must each
  be summed where their partial gradients arise, the gradient of the aux
  terms alone and of the cross-entropy alone (the gates' path): a factor
  of m in either part would hide inside the tolerance of the sum;
* two ``make_train_step`` steps (loss, grad_norm and lr rtol 1e-4, the
  grad_norm equal on every rank, ``dropped_frac``, the moments within
  1e-4 of max |reference| at their ``opt_shardings`` local shapes, the
  params where the first gradient fixes AdamW's sign), as
  ``tests/test_torch_tp_train.py`` holds the dense family;
* the guard: 6 experts on 4 ranks stay whole on every rank, computed whole
  and not summed (prefill logits, loss and gradients);
* every rank's own top-k choices equal to every other rank's, bit for bit,
  in every run and in an unpinned prefill;
* ``models/moe.py``, ``models/transformer.py`` and ``models/layers.py``
  import nothing of the launcher or of JAX.

The routing is discrete: every check against JAX pins the JAX run's
choices, layer by layer, into every rank (``moe.ROUTING_HOOK``); the JAX
runs record each decision through an ordered host callback beside each
``lax.top_k``, and the fixture checks that no recorded token's k-th and
(k+1)-th probabilities lie within 1e-4, so no JAX run could have chosen
otherwise.  One spawn a mesh, each with a deadline.
"""
import ast
import contextlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as JST
import repro.models.moe as JM
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import sharding as TS
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import adamw_init

from torch_spmd_ranks import ep_rank

torch.set_num_threads(1)

B, S, CHUNK, N_DEC = 2, 16, 8, 3
KW = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=CHUNK)
MOE_T, MOE_CF = 64, 1.0
MOE_CASES = [("sort", None), ("einsum", 4)]
TIE_GAP = 1e-4
ARCH = "moonshot-v1-16b-a3b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
LOSSES = {"total": (1.0, 1e-2, 1e-3), "aux": (0.0, 1e-2, 1e-3),
          "gate": (1.0, 0.0, 0.0)}


_SINK: list = [None]            # where the traced callbacks append


def _keep(probs, idx):
    _SINK[0].append((np.asarray(probs, np.float32), np.asarray(idx)))


def _top_k(x, k):
    out = _REAL_TOP_K(x, k)
    jax.debug.callback(_keep, x, out[1], ordered=True)
    return out


_REAL_TOP_K = jax.lax.top_k


@contextlib.contextmanager
def _jax_choices(rec: list):
    """Trace and run JAX functions with every routing decision's
    (probabilities, top-k indices) appended to ``rec`` as they run: an
    ordered host callback beside each ``lax.top_k``, so jitted runs record
    too, and a function traced under one ``rec`` appends to the ``rec`` of
    the run."""
    _SINK[0] = rec
    jax.lax.top_k = _top_k
    try:
        yield
    finally:
        jax.lax.top_k = _REAL_TOP_K
        _SINK[0] = None


def _paths(tree) -> dict:
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
    """:func:`_err` over the elements whose first-step gradient ``g1``
    (JAX's) the gradient test fixes (|g1| above 2e-4 of its leaf's
    largest): below that AdamW's first update, g / (|g| + 1e-8), takes its
    sign from f32 noise (``tests/test_torch_tp_train.py``)."""
    keep = g1.abs() > 2e-4 * g1.abs().max()
    want = torch.as_tensor(np.array(want, np.float32))
    assert got.shape == want.shape
    return float((got.float() - want).abs()[keep].max()
                 / want.abs().max().clamp_min(1e-30))


def _whole(res: list, key) -> dict:
    """path → the leaf reassembled from every rank's ``key(r)`` shards;
    ranks holding a leaf whole agree bit for bit."""
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


def _moe_weights(seed, d, ff, e) -> dict:
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((d, e)) * d ** -0.5
                       ).astype(np.float32),
            "wi": (rng.standard_normal((e, d, 2, ff)) * d ** -0.5
                   ).astype(np.float32),
            "wo": (rng.standard_normal((e, ff, d)) * ff ** -0.5
                   ).astype(np.float32)}


def _grads_fn(jm, ids, labels, mask, parts):
    """Jitted: the loss and the gradient of each weighting ``parts`` of
    (cross-entropy, load balance, router z), through one forward (remat on,
    as the train step) and one pullback a weighting."""
    def terms(p):
        h, aux = jm.apply(p, jnp.asarray(ids), remat=True)
        ce = jm.loss(p, h, jnp.asarray(labels), jnp.asarray(mask),
                     chunk=CHUNK)
        return jnp.stack([ce, aux["load_balance_loss"],
                          aux["router_z_loss"]])

    def run(p):
        y, pull = jax.vjp(terms, p)
        return [(jnp.dot(jnp.asarray(w), y),
                 pull(jnp.asarray(w, jnp.float32))[0]) for w in parts]
    return jax.jit(run)


def _guard_params(jp, jc, seed):
    """``jp`` with its moe leaves drawn anew for ``jc``'s expert count
    (numpy, scaled as the JAX init scales them)."""
    rng = np.random.default_rng(seed)
    L, d, ff, E = jc.n_layers, jc.d_model, jc.d_ff, jc.n_experts
    p = jax.tree.map(np.asarray, jp)
    p["layers"]["moe"] = {
        "router": (rng.standard_normal((L, d, E)) * d ** -0.5
                   ).astype(np.float32),
        "wi": (rng.standard_normal((L, E, d, 2, ff)) * E ** -0.5
               ).astype(np.float32),
        "wo": (rng.standard_normal((L, E, ff, d)) * E ** -0.5
               ).astype(np.float32)}
    return p


@pytest.fixture(scope="module")
def reference():
    """The JAX runs (jitted) with every routing decision recorded:
    ``moe_apply``, the serve steps, the three losses' gradients, two train
    steps, and the guard config's prefill logits and gradients."""
    jc, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = JLM(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(30)
    draws = [(rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
              (rng.random((B, S)) < 0.8).astype(np.float32))
             for _ in range(2)]
    steps = rng.integers(0, jc.vocab, (B, N_DEC)).astype(np.int32)
    pins, gaps = {}, []

    def record(phase, fn, *args):
        rec = []
        with _jax_choices(rec):
            out = jax.block_until_ready(fn(*args))
        pins[phase] = [idx for _, idx in rec]
        for probs, idx in rec:
            top = -np.sort(-probs, axis=-1)
            k = idx.shape[-1]
            gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return out

    out: dict = {"cfg": cfg, "pins": pins, "moe": {}}
    # moe_apply on one layer's weights
    w = _moe_weights(3, jc.d_model, jc.d_ff, jc.n_experts)
    x = rng.standard_normal((B, MOE_T, jc.d_model)).astype(np.float32)
    for mode, groups in MOE_CASES:
        y, aux = record(f"moe_{mode}", jax.jit(
            lambda w, x, g=groups, m=mode: JM.moe_apply(
                w, x, jc.top_k, MOE_CF, g, m)), w, x)
        gw, gx = jax.jit(jax.grad(
            lambda w, x, g=groups, m=mode: jnp.sum(JM.moe_apply(
                w, x, jc.top_k, MOE_CF, g, m)[0] ** 2), argnums=(0, 1)))(w, x)
        out["moe"][mode] = {"y": np.asarray(y),
                            "aux": {k: float(v) for k, v in aux.items()},
                            "C": int(MOE_T * B // (groups or 1) * jc.top_k
                                     / jc.n_experts * MOE_CF),
                            "grads": {"x": np.asarray(gx),
                                      **{k: np.asarray(v)
                                         for k, v in gw.items()}}}
    # the serve steps
    ids0 = jnp.asarray(draws[0][0])
    _, jpre = JST.make_prefill_step(jc)
    out["logits"] = np.asarray(record("p0", jax.jit(jpre), jp,
                                      {"ids": ids0}))
    _, jcache = record("fill", jax.jit(jm.prefill), jp, ids0,
                       jm.init_cache(B, S + N_DEC))
    _, jdec = JST.make_decode_step(jc)
    jdec = jax.jit(jdec)
    out["decode"] = []
    for j in range(N_DEC):
        lg, jcache = record(f"dec{j}", jdec, jp, jcache,
                            {"ids": jnp.asarray(steps[:, j:j + 1]),
                             "pos": S + j})
        out["decode"].append(np.asarray(lg))
    out["cache"] = {k: np.asarray(jcache[k]) for k in ("k", "v")}
    # the losses' gradients (the routing of p0) and two train steps
    got = _grads_fn(jm, *draws[0], list(LOSSES.values()))(jp)
    out["losses"] = {part: (float(loss), _port_paths(grads))
                     for part, (loss, grads) in zip(LOSSES, got)}
    _, jstep = JST.make_train_step(jc, None, seq_parallel=False, **KW)
    jstep = jax.jit(jstep)
    state, metrics = {"params": jp, "opt": j_adamw_init(jp)}, []
    for i, (ids, labels, mask) in enumerate(draws):
        if i == 1:
            record("p1", jax.jit(lambda p, t: jm.apply(p, t, remat=False)),
                   state["params"], jnp.asarray(ids))
        state, met = jstep(state, {"ids": jnp.asarray(ids),
                                   "labels": jnp.asarray(labels),
                                   "mask": jnp.asarray(mask)})
        metrics.append({k: float(v) for k, v in met.items()})
    out["metrics"] = metrics
    out["after"] = {k: _port_paths(v) for k, v in
                    (("params", state["params"]), ("m", state["opt"].m),
                     ("v", state["opt"].v))}
    # the guard: 6 experts, which a model axis of 4 does not divide
    jg, gcfg = (c.reduced(n_experts=6) for c in (jget_config(ARCH),
                                                  get_config(ARCH)))
    jgm = JLM(jg)
    jgp = _guard_params(jp, jg, 4)
    _, jgpre = JST.make_prefill_step(jg)
    glogits = np.asarray(record("g0", jax.jit(jgpre), jgp, {"ids": ids0}))
    ((gloss, ggrads),) = _grads_fn(jgm, *draws[0], [LOSSES["total"]])(jgp)
    out["guard"] = {"cfg": gcfg, "logits": glogits, "loss": float(gloss),
                    "grads": _port_paths(ggrads),
                    "params": params_from_numpy(jgp, gcfg.dtype,
                                                device="cpu")}
    assert min(gaps) > TIE_GAP, f"a near-tie in the routing: {min(gaps)}"
    out["job"] = {
        "cfg": cfg, "kw": KW, "pins": pins,
        "params": params_from_numpy(jax.tree.map(np.asarray, jp), cfg.dtype,
                                    device="cpu"),
        "moe_w": {k: torch.from_numpy(v) for k, v in w.items()},
        "moe_x": torch.from_numpy(x), "moe_k": jc.top_k, "moe_cf": MOE_CF,
        "moe_cases": MOE_CASES,
        "batches": [{"ids": torch.from_numpy(i).long(),
                     "labels": torch.from_numpy(lb),
                     "mask": torch.from_numpy(m)} for i, lb, m in draws],
        "serve": torch.from_numpy(steps).long()}
    return out


_RUNS: dict = {}


def _ranks(ref, model: int) -> list:
    """The ranks' results on a (1, model) mesh (one spawn a mesh): the
    (1, 2) run also serves, the (1, 4) run also runs the guard config."""
    if model not in _RUNS:
        job = dict(ref["job"])
        if model == 4:
            job["serve"] = None
            job["guard"] = (ref["guard"]["cfg"], ref["guard"]["params"])
        _RUNS[model] = TMESH.run_on_local_mesh(
            (1, model), ("data", "model"), ep_rank, job, device="cpu",
            timeout=300)
    return _RUNS[model]


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("mode", [m for m, _ in MOE_CASES])
def test_ep_moe_apply_matches_jax(reference, model, mode):
    ref = reference["moe"][mode]
    cfg = reference["cfg"]
    E = cfg.n_experts
    for r in _ranks(reference, model):
        got = r["moe"][mode]
        assert got["wi"] == (E // model, cfg.d_model, 2, cfg.d_ff)
        assert got["wo"] == (E // model, cfg.d_ff, cfg.d_model)
        assert got["C"] == ref["C"]
        assert _err(got["y"], ref["y"]) <= 2e-4
        for k in ("load_balance_loss", "router_z_loss"):
            np.testing.assert_allclose(got["aux"][k], ref["aux"][k],
                                       rtol=1e-5, atol=1e-6)
        assert got["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"] > 0


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("mode", [m for m, _ in MOE_CASES])
def test_ep_moe_apply_gradients_match_jax(reference, model, mode):
    """The backward of both dispatches under expert parallelism: the
    gates' and the dispatched tokens' gradients summed over the model axis
    (x and the router whole on every rank), each rank's experts' own."""
    want = reference["moe"][mode]["grads"]
    res = _ranks(reference, model)
    got = _whole(res, lambda r: r["moe"][mode]["grads"])
    assert set(got) == set(want)
    for r in res:
        assert tuple(r["moe"][mode]["grads"]["wi"][0].shape)[0] == (
            reference["cfg"].n_experts // model)
    errs = {k: _err(got[k], want[k]) for k in got}
    assert max(errs.values()) <= 2e-4, errs


def test_ep_serving_matches_jax(reference):
    ref, cfg = reference, reference["cfg"]
    res = _ranks(ref, 2)
    for r in res:
        sv = r["serve"]
        assert _err(sv["logits"], ref["logits"]) <= 2e-4
        for got, want in zip(sv["decode"], ref["decode"]):
            assert _err(got, want) <= 2e-4
        L, E, d, ff = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
        sh = sv["shapes"]
        assert sh["layers/moe/wi"] == (L, E // 2, d, 2, ff)
        assert sh["layers/moe/wo"] == (L, E // 2, ff, d)
        assert sh["layers/moe/router"] == (L, d, E)
        assert sh["layers/attn/wq"] == (L, d, cfg.n_heads // 2, cfg.hd)
        assert sh["embed/table"] == (cfg.vocab_padded // 2, d)
    cache = _whole(res, lambda r: r["serve"]["cache"])
    for name in ("k", "v"):
        assert res[0]["serve"]["cache"][name][0].shape[3] == (
            cfg.n_kv_heads // 2)
        assert _err(cache[name], ref["cache"][name]) <= 2e-4


CASES = [(2, True), (2, False), (4, True), (4, False)]
IDS = [f"model{m}-{'seq' if sp else 'noseq'}" for m, sp in CASES]


def _grads_match(res, sp, part, want_loss, want_grads) -> None:
    for r in res:
        loss, _, laid_out, _ = r["grads"][sp][part]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert laid_out
    got = _whole(res, lambda r: r["grads"][sp][part][1])
    assert set(got) == set(want_grads)
    errs = {p: _err(got[p], want_grads[p]) for p in got}
    assert max(errs.values()) <= 2e-4, (part, errs)


@pytest.mark.parametrize("model,sp", CASES, ids=IDS)
def test_ep_loss_and_gradients_match_jax(reference, model, sp):
    res = _ranks(reference, model)
    _grads_match(res, sp, "total", *reference["losses"]["total"])
    want = reference["losses"]["total"][1]
    assert float(want["layers/moe/router"].abs().max()) > 0


@pytest.mark.parametrize("model,sp", CASES, ids=IDS)
def test_ep_aux_and_gate_gradients_alone_match_jax(reference, model, sp):
    """The router's and ``ln2``'s gradient through the aux terms alone
    (whole on every rank) and through the gates alone (a part on each
    rank, summed once)."""
    res = _ranks(reference, model)
    for part in ("aux", "gate"):
        loss, grads = reference["losses"][part]
        assert float(grads["layers/moe/router"].abs().max()) > 0
        assert float(grads["layers/ln2/scale"].abs().max()) > 0
        _grads_match(res, sp, part, loss, grads)


@pytest.mark.parametrize("model,sp", CASES, ids=IDS)
def test_ep_two_train_steps_match_jax(reference, model, sp):
    ref = reference
    res = _ranks(ref, model)
    layout = TMESH.MeshLayout((1, model), ("data", "model"))
    params = ref["job"]["params"]
    specs = _paths(TS.opt_shardings(layout, adamw_init(params), params).m)
    cfg = ref["cfg"]
    for r in res:
        st = r["steps"][sp]
        assert st["step_plain"] and st["moments_laid_out"]
        for got, want in zip(st["metrics"], ref["metrics"]):
            assert set(got) == set(want)
            for k in ("loss", "grad_norm", "lr", "dropped_frac"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6)
        for name in ("m", "v"):
            for path, (local, _, shape) in st[name].items():
                assert tuple(local.shape) == TS.local_shape(
                    layout, specs[path].spec, shape), (name, path)
            assert tuple(st[name]["layers/moe/wi"][0].shape) == (
                cfg.n_layers, cfg.n_experts // model, cfg.d_model, 2,
                cfg.d_ff)
            assert tuple(st[name]["layers/moe/wo"][0].shape) == (
                cfg.n_layers, cfg.n_experts // model, cfg.d_ff, cfg.d_model)
            assert tuple(st[name]["layers/moe/router"][0].shape) == (
                cfg.n_layers, cfg.d_model, cfg.n_experts)
    for i in range(2):          # one number on every rank
        norms = {r["steps"][sp]["metrics"][i]["grad_norm"] for r in res}
        assert len(norms) == 1, norms
    got = _whole(res, lambda r: r["steps"][sp]["params"])
    g1 = ref["losses"]["total"][1]
    errs = {p: _param_err(got[p], ref["after"]["params"][p], g1[p])
            for p in got}
    assert max(errs.values()) <= 1e-4, errs
    for name in ("m", "v"):
        got = _whole(res, lambda r: r["steps"][sp][name])
        errs = {p: _err(got[p], ref["after"][name][p]) for p in got}
        assert max(errs.values()) <= 1e-4, (name, errs)


def test_ep_guard_leaves_the_experts_whole(reference):
    """6 experts on 4 ranks: ``moe/wi`` whole on every rank, the experts
    computed whole and not summed; the prefill logits, the loss and every
    gradient (each rank's copy of the experts' the whole one) as JAX's."""
    g, cfg = reference["guard"], reference["guard"]["cfg"]
    res = _ranks(reference, 4)
    for r in res:
        got = r["guard"]
        assert got["wi"] == (cfg.n_layers, 6, cfg.d_model, 2, cfg.d_ff)
        assert _err(got["logits"], g["logits"]) <= 2e-4
        loss, shards, laid_out, _ = got["grads"]
        np.testing.assert_allclose(loss, g["loss"], rtol=1e-5)
        assert laid_out
        for path in ("layers/moe/wi", "layers/moe/wo", "layers/moe/router"):
            assert _err(shards[path][0], g["grads"][path]) <= 2e-4, path
    grads = _whole(res, lambda r: r["guard"]["grads"][1])
    errs = {p: _err(grads[p], g["grads"][p]) for p in grads}
    assert max(errs.values()) <= 2e-4, errs


@pytest.mark.parametrize("model", [2, 4])
def test_ep_ranks_take_the_same_choices(reference, model):
    """Every rank's own top-k choices (before pinning), in every run and
    in the unpinned prefill, equal every other rank's bit for bit: the
    ranks route the same bits."""
    res = _ranks(reference, model)
    own = res[0]["own"]
    cfg = reference["cfg"]
    assert {("own", i) for i in range(cfg.n_layers)} <= set(own)
    for r in res[1:]:
        assert set(r["own"]) == set(own)
        for key, calls in own.items():
            assert len(r["own"][key]) == len(calls), key
            assert all(torch.equal(a, b)
                       for a, b in zip(r["own"][key], calls)), key


def _imports(path: pathlib.Path) -> list:
    """The absolute module names ``path`` imports, relative imports
    resolved."""
    pkg = list(path.relative_to(SRC.parent).parts[:-1])
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            names.append(".".join(base + ([node.module] if node.module
                                          else [])))
    return names


def test_ep_modules_import_nothing_of_the_launcher_or_jax():
    found = []
    for name in ("moe", "transformer", "layers"):
        for mod in _imports(SRC / "models" / f"{name}.py"):
            top = mod.split(".")[0]
            if (mod.startswith("repro_torch.launch") or top in ("jax",
                                                                "repro")):
                found.append((name, mod))
    assert not found, found
    assert "repro_torch.core.spmd_pipeline" in _imports(
        SRC / "models" / "moe.py")
