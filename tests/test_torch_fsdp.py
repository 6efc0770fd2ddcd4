"""A data axis over more than one rank (FSDP) on the CPU, held against the
JAX package's own sharded steps.

The port's step builders on ``(data 2, model 2)`` and ``(data 2, model 1)``
gloo meshes of ``run_on_local_mesh``: the batch split over ``data`` by
``distribute_batch``, weights by ``param_shardings_serving`` (whole over
``data``) or ``param_shardings`` (a storage-only dim split over ``data``,
gathered a layer), against the JAX package's jitted ``make_prefill_step``,
``make_decode_step``, ``loss_fn`` gradients and ``make_train_step`` on
the same meshes of 4 forced host devices, in a subprocess (the state
placed by ``serve_structs``/``train_state_structs``, the batch by
``batch_spec``), on the same numpy weights and inputs.  Reduced f32
gemma3 (4 layers, window 8, vocab 250 padded to 256), moonshot (4 experts,
top 2), musicgen-large's audio path, hymba (4 heads over 2 kv heads: 2 a
model rank; and 3 heads over 1, whole on every rank while ``attn/wo``'s
rows split) and rwkv at d 256 (whole heads a model rank) and d 192 (a
rank's 96 columns cut head 1), B 4 x S 16, loss chunk 8; every hymba and
rwkv leaf the reference sets to zeros or ones (``dt_bias``, ``A_log``,
``D``, ``mu``, ``mu_c``, ``w_bias``, ``u``, ``ln_scale``) drawn from the
seed as ``tests/test_torch_tp_recurrent.py`` draws them:

* serving under both layouts: the prefill step's logits (a DTensor of the
  rank's rows, read whole by ``collect_batch``), ``LM.prefill``'s cache
  and three teacher-forced decode steps, within 2e-4 of max |reference|;
  each cache leaf's local shape is ``local_shape`` of its ``cache_spec``
  and the JAX cache's shard shape (the recurrent states' B on ``data``);
* the train loss (rtol 1e-5) and every gradient leaf, reassembled, within
  2e-4 of max |reference|, ``seq_parallel`` on and off; two
  ``make_train_step`` steps (loss, grad_norm and lr rtol 1e-4, grad_norm
  equal on every rank, the moments within 1e-4 at their ``opt_shardings``
  local shapes, the params where AdamW's sign is fixed: within 1e-4, or
  on a leaf where the JAX package's own unsharded two steps lie further
  than half that from its sharded ones, within twice that control
  distance — moonshot's ``ln2`` scale, zero at init, reads 5.4e-4 there:
  its second gradient nearly cancels the first in AdamW's first moment,
  which scales the f32 order of sums some 35 times);
* rwkv's second step starts from the JAX sharded run's state after the
  first (its params, moments and count), as
  ``tests/test_torch_tp_recurrent.py`` holds it: at d 256 the tied logits
  reach hundreds (a loss of ~123), and AdamW's first update amplifies the
  f32 noise of the first gradient until the JAX package's own unsharded
  two steps read a second ``grad_norm`` 1.2e-4 off its sharded ones, and
  the port's, carried, 3.4e-4 (its params 2.5-5.6x further off than that
  control); the step from JAX's state is held as the steps above, and a
  carried case holds the port's second step to JAX's step taken from the
  port's own state after the first, the two runs' distance recorded;
* the moe family with the JAX run's routing pinned (no near-tie within
  1e-4): through the whole model (the sort dispatch, 2 groups: a data
  rank's rows), the aux losses and the gradient of the aux terms alone and
  of the cross-entropy alone; ``moe_apply`` alone with the sort and einsum
  dispatches at 1 group (spanning both data ranks) and at 2 and 4 (each
  rank its own), with drops: output, aux rtol 1e-5, ``dropped_frac``
  exact, gradients;
* B 3 on data 2 (gemma3, and rwkv's state): the batch and the cache stay
  whole on every rank and no gradient is summed over ``data``;
* ``global_norm`` over each config's tree by ``param_shardings`` counts
  each leaf once; no path reaches ``DTensor.redistribute`` (it raises in
  the ranks);
* beside the data axis: a (pod 2, model 2) and a (stage 2, model 2)
  prefill each equal the whole run's, and the train step at
  ``scan_chunks`` 2 equals its step at 0 bit for bit
  (``tests/test_torch_remat_sharded.py`` holds both to JAX); refused,
  ``with_spec`` where a ``data`` dim of 2 would move, and a recurrent
  state whose rows of B are not the activations' (the vlm family under a
  data axis: ``tests/test_torch_fsdp_vlm.py``);
* plain tensors in one process, bit for bit, with a (2, 2) layout
  registered or not.

Two JAX subprocesses (the dense, moe and audio configs', the hybrid and
ssm configs') and two spawns (one a mesh), each with a deadline.
"""
import os
import pickle
import subprocess
import sys
import textwrap

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
from repro_torch.launch import steps as TST
from repro_torch.models import layers as TL
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim import AdamWState, adamw_init

from test_torch_ep import (_err, _jax_choices, _moe_weights, _param_err,
                           _whole)
from torch_spmd_ranks import fsdp_rank

torch.set_num_threads(1)

B, S, CHUNK, N_DEC = 4, 16, 8, 3
KW = dict(lr=3e-3, warmup=2, total_steps=10, loss_chunk=CHUNK)
TIE_GAP = 1e-4
# config name -> (arch, reduced() overrides)
ARCHS = {"dense": ("gemma3-12b", {"vocab": 250}),
         "moe": ("moonshot-v1-16b-a3b", {}),
         "audio": ("musicgen-large", {}),
         "hybrid": ("hymba-1.5b", {}),
         "hybrid-whole-heads": ("hymba-1.5b", dict(n_heads=3, n_kv_heads=1)),
         "ssm": ("rwkv6-1.6b", dict(d_model=256)),
         "ssm-cut-head": ("rwkv6-1.6b", dict(d_model=192))}
# the leaves ``ssm_init`` and ``rwkv_init`` set to zeros or ones, drawn
# instead: name -> (low, high) of a uniform draw
STATE_LEAF_DRAWS = {"dt_bias": (-2.0, 0.0), "A_log": (-1.0, 1.0),
                    "D": (0.5, 1.5), "mu": (0.0, 1.0), "mu_c": (0.0, 1.0),
                    "w_bias": (-3.0, 0.0), "u": (-0.5, 0.5),
                    "ln_scale": (0.5, 1.5)}
# the configs whose second train step starts from the JAX run's state after
# the first (the module docstring)
RESTARTED = ("ssm",)
LOSSES = {"total": (1.0, 1e-2, 1e-3), "aux": (0.0, 1e-2, 1e-3),
          "gate": (1.0, 0.0, 0.0)}
# job name -> (config, mesh, batch, what runs)
JOBS = {"dense@2x2": ("dense", (2, 2), B, ("serve", "grads", "steps")),
        "moe@2x2": ("moe", (2, 2), B, ("serve", "grads", "steps")),
        "audio@2x2": ("audio", (2, 2), B, ("serve", "grads")),
        "b3@2x2": ("dense", (2, 2), 3, ("serve", "grads")),
        "dense@2x1": ("dense", (2, 1), B, ("serve", "grads", "steps")),
        "moe@2x1": ("moe", (2, 1), B, ("serve", "grads")),
        "hybrid@2x2": ("hybrid", (2, 2), B, ("serve", "grads", "steps")),
        "hybrid-whole-heads@2x2": ("hybrid-whole-heads", (2, 2), B,
                                   ("serve", "grads")),
        "ssm@2x2": ("ssm", (2, 2), B, ("serve", "grads", "steps")),
        "ssm-cut-head@2x2": ("ssm-cut-head", (2, 2), B, ("serve", "grads")),
        "hybrid@2x1": ("hybrid", (2, 1), B, ("serve", "grads")),
        "ssm-b3@2x2": ("ssm", (2, 2), 3, ("serve", "grads"))}
B3_JOBS = ("b3@2x2", "ssm-b3@2x2")
MOE_T, MOE_CF = 64, 1.0
MOE_CASES = [("sort", 1), ("sort", 2), ("einsum", 1), ("einsum", 4)]

JAX_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.launch.steps as JST
    from repro.configs import get_config
    from repro.launch.mesh import _mesh
    from repro.launch.sharding import (act_spec, batch_spec,
                                       cache_shardings, guard_spec)
    from repro.models import LM
    from repro.models.config import ShapeConfig
    from repro.models.layers import set_attention_mesh
    from repro.optim import adamw_init

    def paths(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(k.key) for k in p): np.asarray(v)
                for p, v in flat}

    jobs = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for name, j in jobs.items():
        cfg = get_config(j["arch"]).reduced(**j["overrides"])
        mesh = _mesh(j["mesh"], tuple(j.get("axes", ("data", "model"))))
        set_attention_mesh(mesh)        # the job's own, as its steps do
        jm = LM(cfg)
        key = "embeds" if cfg.embeds_in else "ids"
        b0 = j["batches"][0]
        nb, ns = b0[key].shape[:2]
        n = j["dec"].shape[1]

        def put(a):
            spec = guard_spec(mesh, P(batch_spec(mesh)[0]), a.shape)
            return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

        def inputs(b):
            return {k: put(v) for k, v in b.items()}

        def kw_of(x):
            return {"embeds": x} if cfg.embeds_in else {}

        r = out[name] = {}
        if "serve" in j["runs"]:
            r["serve"] = {}
            for layout in ("serving", "fsdp"):
                shape = ShapeConfig("s", ns + n, nb, "decode")
                ps = JST.serve_structs(cfg, shape, mesh,
                                       layout == "serving")["param_shardings"]
                p = jax.device_put(j["params"], ps)
                _, pre = JST.make_prefill_step(cfg, mesh)
                x = put(b0[key])
                logits = jax.jit(pre)(p, {key: x})
                cache = jm.init_cache(nb, ns + n)
                cache = jax.device_put(cache,
                                       cache_shardings(mesh, cfg, cache))
                local = {"/".join(str(k.key) for k in q):
                         tuple(v.sharding.shard_shape(v.shape)) for q, v in
                         jax.tree_util.tree_flatten_with_path(cache)[0]}
                fill = jax.jit(lambda p, x, c: jm.prefill(
                    p, None if cfg.embeds_in else x, c, **kw_of(x)))
                _, cache = fill(p, x, cache)
                _, dec = JST.make_decode_step(cfg, mesh)
                dec = jax.jit(dec)
                decs = []
                for t in range(n):
                    lg, cache = dec(p, cache, {key: put(j["dec"][:, t:t + 1]),
                                               "pos": ns + t})
                    decs.append(np.asarray(lg))
                r["serve"][layout] = {"logits": np.asarray(logits),
                                      "decode": decs, "cache": paths(cache),
                                      "cache_local": local}
        _, sh = JST.train_state_structs(cfg, mesh)
        p = jax.device_put(j["params"], sh["params"])
        if "grads" in j["runs"]:
            pcon = JST._layer_param_constraint(mesh)
            sp = NamedSharding(mesh, act_spec(mesh))

            def terms(q, b):
                h, aux = jm.apply(
                    q, b.get("ids"), remat=True, param_constraint=pcon,
                    act_constraint=lambda h: jax.lax.with_sharding_constraint(
                        h, sp), scan_chunks=j["kw"].get("scan_chunks", 0),
                    **kw_of(b.get("embeds")))
                ce = jm.loss(q, h, b["labels"], b["mask"],
                             chunk=j["kw"]["loss_chunk"])
                return jnp.stack([ce, aux["load_balance_loss"],
                                  aux["router_z_loss"]])

            def run(q, b):
                y, pull = jax.vjp(lambda q: terms(q, b), q)
                return [(jnp.dot(jnp.asarray(w, jnp.float32), y),
                         pull(jnp.asarray(w, jnp.float32))[0])
                        for w in j["losses"].values()]

            got = jax.jit(run)(p, inputs(b0))
            r["grads"] = {part: (float(v), paths(g))
                          for part, (v, g) in zip(j["losses"], got)}
        if "steps" in j["runs"]:
            _, step = JST.make_train_step(cfg, mesh, seq_parallel=True,
                                          **j["kw"])
            step = jax.jit(step)
            state = {"params": p, "opt": jax.device_put(
                adamw_init(j["params"]), sh["opt"])}
            mets = []
            for i, b in enumerate(j["batches"]):
                state, met = step(state, inputs(b))
                mets.append({k: float(v) for k, v in met.items()})
                if i == 0:
                    r["params1"] = jax.tree.map(np.asarray, state["params"])
                    r["opt1"] = (int(state["opt"].step),
                                 jax.tree.map(np.asarray, state["opt"].m),
                                 jax.tree.map(np.asarray, state["opt"].v))
            r["steps"] = {"metrics": mets, "params": paths(state["params"]),
                          "m": paths(state["opt"].m),
                          "v": paths(state["opt"].v)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _groups_of(shards: int):
    """JAX's ``moe_groups`` on a layout of ``shards`` batch shards."""
    def moe_groups(n_tokens, n_experts):
        if n_tokens % shards or n_tokens // shards < 4 * n_experts:
            return 1
        return shards
    return moe_groups


def _draws(rng, cfg, nb: int) -> tuple[list, np.ndarray]:
    """Two train batches of ``nb`` rows and the teacher-forced decode
    inputs (ids, or embeddings for a model that takes them)."""
    batches = []
    for _ in range(2):
        b = {"labels": rng.integers(0, cfg.vocab, (nb, S)).astype(np.int32),
             "mask": (rng.random((nb, S)) < 0.8).astype(np.float32)}
        if cfg.embeds_in:
            b["embeds"] = rng.standard_normal((nb, S, cfg.d_model)
                                              ).astype(np.float32)
        else:
            b["ids"] = rng.integers(0, cfg.vocab, (nb, S)).astype(np.int32)
        batches.append(b)
    if cfg.embeds_in:
        dec = rng.standard_normal((nb, N_DEC, cfg.d_model)).astype(np.float32)
    else:
        dec = rng.integers(0, cfg.vocab, (nb, N_DEC)).astype(np.int32)
    return batches, dec


def _pins(jc, jp, batches, dec, params1, gaps: list,
          shards: int = 2) -> dict:
    """The routing of every moe call of the port's runs, recorded from the
    JAX package's unsharded functions with its routing groups those of a
    batch of ``shards`` shards (``moe_groups``): the prefill step ("p0",
    also the gradients' and step 1's), and where ``dec`` is given,
    ``LM.prefill`` ("fill") and a decode step a column of ``dec``
    ("dec<j>"); where ``params1`` is, step 2's forward ("p1") from it, the
    sharded JAX run's after its step 1 (an unsharded step's differ where
    AdamW's first update takes its sign from f32 noise)."""
    jm = JLM(jc)
    pins = {}

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

    real = JM.moe_groups
    JM.moe_groups = _groups_of(shards)
    try:
        ids0 = jnp.asarray(batches[0]["ids"])
        _, jpre = JST.make_prefill_step(jc)
        record("p0", jax.jit(jpre), jp, {"ids": ids0})
        n = 0 if dec is None else dec.shape[1]
        if n:
            _, cache = record("fill", jax.jit(jm.prefill), jp, ids0,
                              jm.init_cache(B, S + n))
            _, jdec = JST.make_decode_step(jc)
            jdec = jax.jit(jdec)
        for j in range(n):
            _, cache = record(f"dec{j}", jdec, jp, cache,
                              {"ids": jnp.asarray(dec[:, j:j + 1]),
                               "pos": S + j})
        if params1 is not None:
            record("p1", jax.jit(lambda p, t: jm.apply(p, t, remat=False)),
                   params1, jnp.asarray(batches[1]["ids"]))
    finally:
        JM.moe_groups = real
    return pins


def _unsharded_steps(jc, jp, batches, opt=None, shards: int = 2,
                     moments: bool = False, kw: dict = KW) -> dict:
    """The JAX package's ``make_train_step`` steps with no mesh (the
    routing groups of a batch of ``shards`` shards; its options ``kw``),
    one a batch of ``batches``, from ``jp`` and ``opt`` (a JAX optimizer
    state; fresh moments when None): path → params after them, the control
    for the sharded steps' params; with ``moments``, {"params", "m", "v"},
    each path → leaf."""
    real = JM.moe_groups
    JM.moe_groups = _groups_of(shards)
    try:
        _, step = JST.make_train_step(jc, None, **kw)
        step = jax.jit(step)
        state = {"params": jp,
                 "opt": j_adamw_init(jp) if opt is None else opt}
        for b in batches:
            state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    finally:
        JM.moe_groups = real
    if moments:
        return {"params": _np_paths(state["params"]),
                "m": _np_paths(state["opt"].m),
                "v": _np_paths(state["opt"].v)}
    return _np_paths(state["params"])


def _draw_state_leaves(jp, rng) -> dict:
    """``jp`` with the hybrid or ssm block's zero- and one-initialised
    leaves (:data:`STATE_LEAF_DRAWS`) drawn from ``rng``."""
    blk = "rwkv" if "rwkv" in jp["layers"] else "ssm"
    jp["layers"][blk] = {
        k: (jnp.asarray(rng.uniform(*STATE_LEAF_DRAWS[k], v.shape), v.dtype)
            if k in STATE_LEAF_DRAWS else v)
        for k, v in jp["layers"][blk].items()}
    return jp


def _jax_opt(step: int, m, v):
    """The JAX package's optimizer state at ``step`` holding moments ``m``
    and ``v`` (trees of arrays)."""
    st = j_adamw_init(m)
    return type(st)(step=jnp.asarray(step, st.step.dtype),
                    m=jax.tree.map(jnp.asarray, m),
                    v=jax.tree.map(jnp.asarray, v))


def _path_tree(paths: dict, like) -> dict:
    """``like``'s tree holding, at each path, ``paths[path]`` as a JAX
    array."""
    return TS.map_with_path(lambda p, _: jnp.asarray(np.asarray(
        paths[TS.path_str(p)], np.float32)), like)


def _np_paths(tree) -> dict:
    """path → numpy leaf of a JAX-laid tree."""
    out = {}
    TS.map_with_path(lambda p, a: out.__setitem__(TS.path_str(p),
                                                  np.asarray(a)), tree)
    return out


def _moe_apply_ref(jc, rng, gaps: list) -> tuple[dict, dict]:
    """``moe_apply`` of the JAX package on one layer's weights and x [B, T,
    d], each (mode, G) of :data:`MOE_CASES`: output, aux, C, the gradient
    of sum(y²), and the routing → (references, the port's job)."""
    w = _moe_weights(5, jc.d_model, jc.d_ff, jc.n_experts)
    x = rng.standard_normal((B, MOE_T, jc.d_model)).astype(np.float32)
    refs, pins = {}, {}
    for mode, groups in MOE_CASES:
        def fn(w, x, g=groups, m=mode):
            return JM.moe_apply(w, x, jc.top_k, MOE_CF, g, m)
        rec = []
        with _jax_choices(rec):
            y, aux = jax.block_until_ready(jax.jit(fn)(w, x))
        pins[f"moe_{mode}{groups}"] = [idx for _, idx in rec]
        for probs, idx in rec:
            top = -np.sort(-probs, axis=-1)
            k = idx.shape[-1]
            gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        gw, gx = jax.jit(jax.grad(lambda w, x: jnp.sum(fn(w, x)[0] ** 2),
                                  argnums=(0, 1)))(w, x)
        refs[f"{mode}{groups}"] = {
            "y": np.asarray(y), "aux": {k: float(v) for k, v in aux.items()},
            "C": int(B * MOE_T // groups * jc.top_k / jc.n_experts * MOE_CF),
            "grads": {"x": np.asarray(gx),
                      **{k: np.asarray(v) for k, v in gw.items()}}}
    job = {"w": {k: torch.from_numpy(v) for k, v in w.items()},
           "x": torch.from_numpy(x), "k": jc.top_k, "cf": MOE_CF,
           "cases": MOE_CASES, "pins": pins}
    return refs, job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's sharded runs (a subprocess on 4 forced host
    devices; step 2's routing is recorded from its step-1 params) and the
    port's ranks on the (2, 2) and (2, 1) meshes."""
    tmp = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(37)
    # the hybrid and ssm configs' state leaves and inputs: a stream of
    # their own, so the dense, audio and moe configs' draws stay as they were
    rec_rng = np.random.default_rng(41)
    params, jcfgs, cfgs = {}, {}, {}
    for fam, (arch, over) in ARCHS.items():
        jcfgs[fam] = jget_config(arch).reduced(**over)
        cfgs[fam] = get_config(arch).reduced(**over)
        jp = jax.jit(JLM(jcfgs[fam]).init)(jax.random.PRNGKey(0))
        if jcfgs[fam].rwkv or jcfgs[fam].hybrid:
            jp = _draw_state_leaves(jp, rec_rng)
        params[fam] = (jp, jax.tree.map(np.asarray, jp))
    drawn: dict = {}            # one draw a config and batch: both meshes'
    for fam, _, nb, _ in JOBS.values():
        if (fam, nb) not in drawn:
            drawn[fam, nb] = _draws(rng if fam in ("dense", "moe", "audio")
                                    else rec_rng, cfgs[fam], nb)
    draws = {name: drawn[fam, nb] for name, (fam, _, nb, _) in JOBS.items()}
    jobs = {name: {"arch": ARCHS[fam][0], "overrides": ARCHS[fam][1],
                   "mesh": mesh, "params": params[fam][1],
                   "batches": draws[name][0], "dec": draws[name][1],
                   "runs": runs, "kw": KW,
                   "losses": LOSSES if fam == "moe" else
                   {"total": LOSSES["total"]}}
            for name, (fam, mesh, _, runs) in JOBS.items()}
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    jax_runs = []           # two subprocesses: their jit compiles overlap
    first = ("dense", "moe", "audio")
    for i, part in enumerate((first, tuple(c for c in ARCHS
                                           if c not in first))):
        with open(tmp / f"in{i}.pkl", "wb") as f:
            pickle.dump({n: j for n, j in jobs.items()
                         if JOBS[n][0] in part}, f)
        jax_runs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, str(tmp / f"in{i}.pkl"),
             str(tmp / f"out{i}.pkl")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        gaps: list = []
        moe_ref, moe_job = _moe_apply_ref(jcfgs["moe"], rng, gaps)
        control = {name: _unsharded_steps(jcfgs[fam], params[fam][0],
                                          draws[name][0])
                   for name, (fam, _, _, what) in JOBS.items()
                   if "steps" in what and fam not in RESTARTED}
        ref = {}
        for i, run in enumerate(jax_runs):
            _, err = run.communicate(timeout=900)
            assert run.returncode == 0, err[-3000:]
            with open(tmp / f"out{i}.pkl", "rb") as f:
                ref.update(pickle.load(f))
        restart = {}            # the JAX run's state after its first step
        for name, (fam, _, _, what) in JOBS.items():
            if "steps" in what and fam in RESTARTED:
                step1, m1, v1 = ref[name]["opt1"]
                p1 = ref[name]["params1"]
                control[name] = _unsharded_steps(
                    jcfgs[fam], jax.tree.map(jnp.asarray, p1),
                    draws[name][0][1:], _jax_opt(step1, m1, v1))
                restart[name] = (
                    params_from_numpy(p1, cfgs[fam].dtype, device="cpu"),
                    AdamWState(step=torch.tensor(step1, dtype=torch.int32),
                               m=params_from_numpy(m1, cfgs[fam].dtype,
                                                   device="cpu"),
                               v=params_from_numpy(v1, cfgs[fam].dtype,
                                                   device="cpu")))
        pins = _pins(jcfgs["moe"], params["moe"][0], draws["moe@2x2"][0],
                     draws["moe@2x2"][1], ref["moe@2x2"]["params1"], gaps)
        assert min(gaps) > TIE_GAP, f"a near-tie in the routing: {min(gaps)}"

        def port_job(name):
            fam, _, _, what = JOBS[name]
            batches, dec = draws[name]
            return {"cfg": cfgs[fam], "kw": KW,
                    "params": params_from_numpy(params[fam][1],
                                                cfgs[fam].dtype,
                                                device="cpu"),
                    "batches": [{k: torch.from_numpy(v) for k, v in
                                 b.items()} for b in batches],
                    "dec": torch.from_numpy(dec),
                    "pins": pins if fam == "moe" else None,
                    "serve": "serve" in what,
                    "grads": ({"total": None,
                               **{k: LOSSES[k] for k in ("aux", "gate")}}
                              if fam == "moe" else {"total": None})
                    if "grads" in what else None,
                    "steps": "steps" in what,
                    "restart": restart.get(name)}

        port = {}
        for mesh in ((2, 2), (2, 1)):
            names = [n for n, j in JOBS.items() if j[1] == mesh]
            extra = ({"moe_job": moe_job, "refusals": cfgs["dense"]}
                     if mesh == (2, 2) else {})
            port[mesh] = TMESH.run_on_local_mesh(
                mesh, ("data", "model"), fsdp_rank,
                {n: port_job(n) for n in names}, device="cpu", timeout=480,
                **extra)
    finally:
        for run in jax_runs:
            run.kill()
    return {"ref": ref, "port": port, "cfgs": cfgs, "jcfgs": jcfgs,
            "moe_ref": moe_ref, "draws": draws,
            "params": {f: p[1] for f, p in params.items()},
            "control": control, "jsteps": {}}


def _ranks(runs, name) -> list:
    return [r[name] for r in runs["port"][JOBS[name][1]]]


def _layout(name):
    return TMESH.MeshLayout(JOBS[name][1], ("data", "model"))


SERVE = [(n, lay) for n, j in JOBS.items() if "serve" in j[3]
         for lay in ("serving", "fsdp")]


@pytest.mark.parametrize("name,layout", SERVE,
                         ids=[f"{n}-{lay}" for n, lay in SERVE])
def test_fsdp_serving_matches_jax_sharded(runs, name, layout):
    ref = runs["ref"][name]["serve"][layout]
    res = _ranks(runs, name)
    cfg = runs["cfgs"][JOBS[name][0]]
    nb = JOBS[name][2]
    split = nb % 2 == 0
    got = [r["serve"][layout] for r in res]
    logits = _whole(got, lambda g: {"x": g["logits"]})["x"]
    assert _err(logits, ref["logits"]) <= 2e-4
    for g in got:
        assert g["laid_out"]
        assert torch.equal(g["collected"], logits)
        assert g["input_local"][0] == (nb // 2 if split else nb)
    for j in range(N_DEC):
        dec = _whole(got, lambda g: {"x": g["decode"][j]})["x"]
        assert _err(dec, ref["decode"][j]) <= 2e-4
    cache = _whole(got, lambda g: g["cache"])
    assert set(cache) == set(ref["cache"])
    for path in cache:
        assert _err(cache[path], ref["cache"][path]) <= 2e-4, path
    layout_ = _layout(name)
    whole = TST.abstract_cache(cfg, nb, S + N_DEC)
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.cache_shardings(layout_, cfg, whole))
    for g in got:
        for path, (local, _, shape) in g["cache"].items():
            assert tuple(local.shape) == TS.local_shape(
                layout_, specs[path], shape) == ref["cache_local"][path], path
            assert local.shape[1] == (nb // 2 if split else nb)


GRADS = [(n, sp) for n, j in JOBS.items() if "grads" in j[3]
         for sp in (True, False)]


@pytest.mark.parametrize("name,sp", GRADS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in GRADS])
def test_fsdp_loss_and_gradients_match_jax_sharded(runs, name, sp):
    want_loss, want = runs["ref"][name]["grads"]["total"]
    res = _ranks(runs, name)
    for r in res:
        loss, _, laid_out, _ = r["grads"][sp]["total"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert laid_out
    got = _whole(res, lambda r: r["grads"][sp]["total"][1])
    assert set(got) == set(want)
    errs = {p: _err(got[p], want[p]) for p in got}
    assert max(errs.values()) <= 2e-4, errs


STEPS = [(n, sp) for n, j in JOBS.items()
         if "steps" in j[3] and j[0] not in RESTARTED
         for sp in (True, False)]


@pytest.mark.parametrize("name,sp", STEPS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in STEPS])
def test_fsdp_two_train_steps_match_jax_sharded(runs, name, sp):
    ref = runs["ref"][name]
    res = _ranks(runs, name)
    layout = _layout(name)
    whole = TST.abstract_params(runs["cfgs"][JOBS[name][0]])
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.opt_shardings(layout, adamw_init(whole), whole).m)
    for r in res:
        st = r["steps"][sp]
        assert st["step_plain"] and st["moments_laid_out"]
        for got, want in zip(st["metrics"], ref["steps"]["metrics"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6)
        for nm in ("m", "v"):
            for path, (local, _, shape) in st[nm].items():
                assert tuple(local.shape) == TS.local_shape(
                    layout, specs[path], shape), (nm, path)
    for i in range(2):          # one number on every rank
        norms = {r["steps"][sp]["metrics"][i]["grad_norm"] for r in res}
        assert len(norms) == 1, norms
    g1 = {p: torch.as_tensor(np.asarray(v, np.float32)) for p, v in
          runs["ref"][name]["grads"]["total"][1].items()}
    got = _whole(res, lambda r: r["steps"][sp]["params"])
    unsharded = runs["control"][name]
    over = {}
    for p in got:
        err = _param_err(got[p], ref["steps"]["params"][p], g1[p])
        control = _param_err(torch.as_tensor(unsharded[p]),
                             ref["steps"]["params"][p], g1[p])
        if err > max(1e-4, 2 * control):
            over[p] = (err, control)
    assert not over, over
    for nm in ("m", "v"):
        got = _whole(res, lambda r: r["steps"][sp][nm])
        errs = {p: _err(got[p], ref["steps"][nm][p]) for p in got}
        assert max(errs.values()) <= 1e-4, (nm, errs)


@pytest.mark.parametrize("name,sp", [("moe@2x2", True), ("moe@2x2", False),
                                     ("moe@2x1", True)],
                         ids=["2x2-seq", "2x2-noseq", "2x1-seq"])
def test_fsdp_moe_aux_and_gate_gradients_alone_match_jax_sharded(runs, name,
                                                                  sp):
    """The moe model on a batch split over data, the routing groups a data
    rank's rows: the aux losses (the global means, rtol 1e-5), and the
    gradient of the aux terms alone and of the cross-entropy alone (the
    router's and ``ln2``'s, among every leaf), each against JAX's."""
    res = _ranks(runs, name)
    for part in ("aux", "gate"):
        want_loss, want = runs["ref"][name]["grads"][part]
        assert float(np.abs(want["layers/moe/router"]).max()) > 0
        for r in res:
            loss, _, laid_out, _ = r["grads"][sp][part]
            np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
            assert laid_out
        got = _whole(res, lambda r: r["grads"][sp][part][1])
        errs = {p: _err(got[p], want[p]) for p in got}
        assert max(errs.values()) <= 2e-4, (part, errs)
    _, _, _, aux = res[0]["grads"][sp]["total"]
    want_total = runs["ref"][name]["grads"]["total"][0]
    np.testing.assert_allclose(aux["total"], want_total, rtol=1e-5)
    assert {r["grads"][sp]["total"][3]["dropped_frac"] for r in res} == {
        aux["dropped_frac"]}


@pytest.mark.parametrize("mode,groups", MOE_CASES,
                         ids=[f"{m}-G{g}" for m, g in MOE_CASES])
def test_fsdp_moe_apply_on_a_data_split_batch_matches_jax(runs, mode,
                                                          groups):
    """``moe_apply`` on x split over data: G from the global token count
    (G 1: one group spanning both ranks' rows, the positions counted on
    from the rank before; G 2 and 4: each rank its own groups), C of the
    global group, the output and the gradients within 2e-4 of max
    |reference|, the aux losses (the global means) rtol 1e-5 and
    ``dropped_frac`` exactly, with drops."""
    ref = runs["moe_ref"][f"{mode}{groups}"]
    res = [r["moe_apply"][f"{mode}{groups}"] for r in runs["port"][(2, 2)]]
    for r in res:
        assert r["G"] == groups and r["C"] == ref["C"]
        for k in ("load_balance_loss", "router_z_loss"):
            np.testing.assert_allclose(r["aux"][k], ref["aux"][k],
                                       rtol=1e-5, atol=1e-6)
        assert r["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"] > 0
    y = _whole(res, lambda r: {"y": r["y"]})["y"]
    assert _err(y, ref["y"]) <= 2e-4
    got = _whole(res, lambda r: r["grads"])
    assert set(got) == set(ref["grads"])
    errs = {k: _err(got[k], ref["grads"][k]) for k in got}
    assert max(errs.values()) <= 2e-4, errs


@pytest.mark.parametrize("name", B3_JOBS)
def test_fsdp_batch_the_axis_does_not_divide_stays_whole(runs, name):
    """B 3 on data 2: the guard leaves the batch and the cache whole on
    every rank, every rank computes all 3 rows, and no gradient is summed
    over data (a sum would double every one against JAX's).  rwkv's
    state (``S``, ``tm_last``, ``cm_last``) stays split over model alone,
    as ``cache_spec`` lays it out."""
    res = _ranks(runs, name)
    rwkv = runs["cfgs"][JOBS[name][0]].rwkv
    for r in res:
        assert all(shape[0] == 3 for shape in r["batch_local"].values())
        for lay in ("serving", "fsdp"):
            cache = r["serve"][lay]["cache"]
            assert r["serve"][lay]["input_local"][0] == 3
            if rwkv:
                assert set(cache) == {"S", "tm_last", "cm_last"}
            for path, (local, bounds, shape) in cache.items():
                assert local.shape[1] == 3 == shape[1], path
                if rwkv:
                    assert local.shape[-1] == shape[-1] // 2, path
    want_loss, want = runs["ref"][name]["grads"]["total"]
    for sp in (True, False):
        got = _whole(res, lambda r: r["grads"][sp]["total"][1])
        errs = {p: _err(got[p], want[p]) for p in got}
        assert max(errs.values()) <= 2e-4, errs


RESTARTS = [(n, sp) for n, j in JOBS.items()
            if "steps" in j[3] and j[0] in RESTARTED for sp in (True, False)]


@pytest.mark.parametrize("name,sp", RESTARTS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in RESTARTS])
def test_fsdp_recurrent_steps_from_jax_first_step_match_jax_sharded(
        runs, name, sp):
    """rwkv's two ``make_train_step`` steps, the second from the JAX
    sharded run's state after the first (the module docstring), each held
    to JAX's: the metrics (rtol 1e-4, grad_norm one number on every rank),
    the moments within 1e-4 at their ``opt_shardings`` local shapes; the
    params after step 1 where AdamW's sign is fixed within 1e-4, and after
    step 2 within 1e-4 or twice the distance of the JAX package's own
    unsharded step from the same state."""
    ref = runs["ref"][name]
    res = _ranks(runs, name)
    layout = _layout(name)
    whole = TST.abstract_params(runs["cfgs"][JOBS[name][0]])
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.opt_shardings(layout, adamw_init(whole), whole).m)
    for i in range(2):
        for r in res:
            st = r["steps"][sp][i]
            assert st["step"] == i + 1 and st["step_plain"]
            assert st["moments_laid_out"]
            (got,) = st["metrics"]
            want = ref["steps"]["metrics"][i]
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=1e-6)
            for nm in ("m", "v"):
                for path, (local, _, shape) in st[nm].items():
                    assert tuple(local.shape) == TS.local_shape(
                        layout, specs[path], shape), (nm, path)
        norms = {r["steps"][sp][i]["metrics"][0]["grad_norm"] for r in res}
        assert len(norms) == 1, norms
    g1 = {p: torch.as_tensor(np.asarray(v, np.float32)) for p, v in
          ref["grads"]["total"][1].items()}
    _, m1, v1 = ref["opt1"]
    want1 = {"params": _np_paths(ref["params1"]), "m": _np_paths(m1),
             "v": _np_paths(v1)}
    got = _whole(res, lambda r: r["steps"][sp][0]["params"])
    errs = {p: _param_err(got[p], want1["params"][p], g1[p]) for p in got}
    assert max(errs.values()) <= 1e-4, errs
    got = _whole(res, lambda r: r["steps"][sp][1]["params"])
    unsharded, over = runs["control"][name], {}
    for p in got:
        err = _param_err(got[p], ref["steps"]["params"][p], g1[p])
        control = _param_err(torch.as_tensor(unsharded[p]),
                             ref["steps"]["params"][p], g1[p])
        if err > max(1e-4, 2 * control):
            over[p] = (err, control)
    assert not over, over
    for i, want in enumerate((want1, ref["steps"])):
        for nm in ("m", "v"):
            got = _whole(res, lambda r: r["steps"][sp][i][nm])
            errs = {p: _err(got[p], want[nm][p]) for p in got}
            assert max(errs.values()) <= 1e-4, (i, nm, errs)


@pytest.mark.parametrize("name,sp", RESTARTS, ids=[
    f"{n}-{'seq' if sp else 'noseq'}" for n, sp in RESTARTS])
def test_fsdp_carried_second_step_is_jax_step_from_the_first(
        runs, name, sp, record_property):
    """rwkv's two steps carried on the ranks: the first is the one-step
    run's bit for bit, and the second is JAX's step (unsharded, the same
    values) taken from the port's own state after the first (its params,
    moments and count), the metrics rtol 1e-4 and the moments within
    1e-4.  Both distances of the carried moments, to that step and to the
    JAX sharded run's own second step, are recorded as the test's
    properties (``--junitxml``)."""
    conf = JOBS[name][0]
    res = _ranks(runs, name)
    for r in res:
        got, one = r["carried"][sp], r["steps"][sp][0]
        assert got["step"] == 2 and got["step_plain"]
        assert got["moments_laid_out"]
        assert got["metrics"][0] == one["metrics"][0]
    first = {n: _whole(res, lambda r: r["steps"][sp][0][n])
             for n in ("params", "m", "v")}
    if conf not in runs["jsteps"]:
        _, jstep = JST.make_train_step(runs["jcfgs"][conf], None,
                                       seq_parallel=False, **KW)
        runs["jsteps"][conf] = jax.jit(jstep)
    like = runs["params"][conf]
    state = {"params": _path_tree(first["params"], like),
             "opt": _jax_opt(1, _path_tree(first["m"], like),
                             _path_tree(first["v"], like))}
    batch = {k: jnp.asarray(v) for k, v in runs["draws"][name][0][1].items()}
    state, met = runs["jsteps"][conf](state, batch)
    got = res[0]["carried"][sp]["metrics"][1]
    own = runs["ref"][name]["steps"]["metrics"][1]["grad_norm"]
    record_property("grad_norm_off_jax_carried",
                    abs(got["grad_norm"] - own) / own)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], float(met[k]), rtol=1e-4)
    want = {"m": _np_paths(state["opt"].m), "v": _np_paths(state["opt"].v)}
    for n in ("m", "v"):
        got = _whole(res, lambda r: r["carried"][sp][n])
        errs = {p: _err(got[p], want[n][p]) for p in got}
        record_property(f"{n}_off_jax_from_the_first", max(errs.values()))
        record_property(f"{n}_off_jax_carried", max(
            _err(got[p], runs["ref"][name]["steps"][n][p]) for p in got))
        assert max(errs.values()) <= 1e-4, (n, errs)


def test_fsdp_global_norm_counts_each_leaf_once(runs):
    """``global_norm`` of each config's params tree by ``param_shardings``
    on (2, 2) and (2, 1): the squares of a leaf split over data summed
    over it, a leaf whole over it (the hybrid and ssm blocks' small
    leaves, the norms, the router) counted once; the whole tree's norm."""
    for mesh in ((2, 2), (2, 1)):
        names = [n for n, j in JOBS.items() if j[1] == mesh]
        for r in runs["port"][mesh]:
            for name in names:
                got, want, n = r[name]["norm"]
                assert n >= 10
                np.testing.assert_allclose(got, want, rtol=1e-6)


OTHERS = ("pod", "scan_chunks", "with_spec", "stage")


@pytest.mark.parametrize("what", OTHERS)
def test_fsdp_runs_beside_the_data_axis_and_with_spec_raises(runs, what):
    """Beside the (2, 2) mesh's own steps: a pod axis of 2 and a stage
    axis of 2 run, the prefill step on a (pod 2, model 2) and on a (stage
    2, model 2) mesh of the same ranks (the prompt split over pod; stage
    splits nothing) each equal to the whole run's logits within 2e-4 of
    their max (``tests/test_torch_pod.py`` and
    ``tests/test_torch_remat_sharded.py`` hold them to JAX); the train
    step at scan_chunks 2 equals its step at 0 bit for bit; with_spec
    still raises, by name, where a data dim of 2 would have to move
    (unshard gathers it).  (The vlm family runs under a data axis:
    ``tests/test_torch_fsdp_vlm.py``.)"""
    for r in runs["port"][(2, 2)]:
        got = r["refused"]
        if what in ("pod", "stage"):
            logits, whole = got[what]
            assert logits.shape == whole.shape and logits.shape[0] == 4
            assert _err(logits, whole.numpy()) <= 2e-4
        elif what == "scan_chunks":
            equal, loss = got[what]
            assert equal and np.isfinite(loss)
        else:
            assert "moves a batch axis ['data']" in got[what], got[what]
        assert got["with_spec_same"]
        assert got["unshard"] == ((4, 4), [True, True], True)


def test_fsdp_state_of_other_rows_is_refused(runs):
    """On a (2, 2) mesh a recurrent state whose rows of B are not the
    activations' raises, though it holds as many: a state split over data
    beside a whole batch, and a whole state beside a data rank's rows; a
    state split over data beside the batch split the same way runs."""
    for r in runs["port"][(2, 2)]:
        got = r["refused"]["state_rows"]
        assert got["same"] == ""
        for k in ("batch whole", "state whole"):
            assert "rows" in got[k], (k, got[k])


def test_plain_tensors_are_unchanged_by_a_data_layout(runs):
    """One process holding the model whole: the serve steps and the loss
    and gradients, with a (2, 2) layout registered and without, bit for
    bit (the dense and audio families; a moe layer's routing groups follow
    the layout, as in JAX)."""
    layout = TMESH.MeshLayout((2, 2), ("data", "model"))
    for fam in ("dense", "audio"):
        cfg = runs["cfgs"][fam]
        name = "dense@2x2" if fam == "dense" else "audio@2x2"
        batches, dec = runs["draws"][name]
        params = params_from_numpy(runs["params"][fam], cfg.dtype,
                                   device="cpu")
        key = "embeds" if cfg.embeds_in else "ids"
        batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        dec = torch.from_numpy(dec)
        outs = []
        try:
            for mesh in (None, layout):
                model, pre = TST.make_prefill_step(cfg, mesh)
                _, step = TST.make_decode_step(cfg, mesh)
                logits = pre(params, {key: batch[key]})
                cache = model.init_cache(B, S + N_DEC, device="cpu")
                model.prefill(params, None if cfg.embeds_in else batch[key],
                              cache, **({"embeds": batch[key]}
                                        if cfg.embeds_in else {}))
                decs = [step(params, cache, {key: dec[:, j:j + 1],
                                             "pos": S + j})[0]
                        for j in range(N_DEC)]
                ce, grads, _ = TST.loss_and_grads(model, params, batch,
                                                  loss_chunk=CHUNK)
                outs.append((logits, decs, cache, ce, grads))
                TL.set_attention_mesh(None)
        finally:
            TL.set_attention_mesh(None)
        (l0, d0, c0, e0, g0), (l1, d1, c1, e1, g1) = outs
        assert torch.equal(l0, l1) and torch.equal(e0, e1)
        assert all(torch.equal(a, b) for a, b in zip(d0, d1))
        assert all(torch.equal(c0[k], c1[k]) for k in ("k", "v"))
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("name", ["hybrid", "ssm"])
def test_recurrent_state_of_other_rows_is_refused(name):
    """A recurrent state whose rows of B are not the ones the activations
    hold (a whole batch's state beside one data rank's rows) raises, for
    the hybrid block's ``ssm`` state and rwkv's ``S``, ``tm_last`` and
    ``cm_last``; the state of the same rows runs."""
    from repro_torch.models import LM, rwkv, ssm

    cfg = get_config(ARCHS[name][0]).reduced(**ARCHS[name][1])
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    layer = {k: {n: v[0] for n, v in blk.items()}
             for k, blk in params["layers"].items()}
    x = torch.randn(B // 2, 3, cfg.d_model)
    for rows in (B, B // 2):
        cache = LM(cfg).init_cache(rows, 8, device="cpu")
        state = {k: v[0] for k, v in (cache if cfg.rwkv
                                      else cache["ssm"]).items()}

        def run():
            if cfg.rwkv:
                return rwkv.rwkv_block(layer["rwkv"], x, layer["ln1"],
                                       layer["ln2"], state=state)
            return ssm.ssm_apply(layer["ssm"], x, state=state)

        if rows == B // 2:
            run()
            continue
        with pytest.raises(ValueError, match="rows"):
            run()
