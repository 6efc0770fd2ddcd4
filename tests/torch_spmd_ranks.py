"""Functions the multi-process tests of the port run in every rank of
``run_on_local_mesh``.  Ranks unpickle them by import path, so they live
in a module that imports neither JAX nor the JAX package."""
import numpy as np
import torch

from repro_torch.core import DeviceInventory, pipeline_microbatches


def tanh_block(p, x):
    return torch.tanh(x @ p["w"])


def pipeline_rank(mesh, W, xs, boundaries, batch_axis=None):
    """The pipeline of ``tanh(x @ w)`` layers: outputs, the gradient of
    mean(out²) on this rank's copy of W, and the rank's stats."""
    W = W.clone().requires_grad_(True)
    stats = {}
    out = pipeline_microbatches(mesh, tanh_block, {"w": W}, boundaries, xs,
                                batch_axis=batch_axis, stats=stats)
    (out.float() ** 2).mean().backward()
    return {"out": out.detach(), "grad": W.grad, "stats": stats,
            "coord": mesh.coord}


def placement_rank(mesh, params, specs, x_heads):
    """DTensors of ``params`` under ``specs`` (path → spec), their local
    shapes; ``_con_heads`` on a replicated [B, T, H, hd] tensor; the
    mesh's inventory."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.sharding import placements
    from repro_torch.models import layers

    dm = mesh.device_mesh
    local = {}
    for path, spec in specs.items():
        dt = distribute_tensor(params[path], dm, placements(dm, spec))
        local[path] = {"shape": tuple(dt.to_local().shape),
                       "placements": [str(p) for p in dt.placements],
                       "whole": bool(torch.equal(dt.full_tensor(),
                                                 params[path]))}
    x = distribute_tensor(x_heads, dm, [Replicate()] * dm.ndim)
    layers.set_attention_mesh(mesh.layout)
    try:
        y = layers._con_heads(x)
        plain = layers._con_heads(x_heads)
    finally:
        layers.set_attention_mesh(None)
    inv = DeviceInventory.from_mesh(dm)
    return {"local": local,
            "heads": {"placements": [str(p) for p in y.placements],
                      "shape": tuple(y.to_local().shape),
                      "whole": bool(torch.equal(y.full_tensor(), x_heads)),
                      "plain_unchanged": plain is x_heads},
            "inventory": [(s.ordinal, s.device_id, s.coord, s.platform)
                          for s in inv],
            "ndindex": [tuple(int(c) for c in i)
                        for i in np.ndindex(tuple(mesh.shape.values()))]}


def sleeping_rank(mesh, who):
    """Rank ``who`` hangs; the others return at once."""
    import time
    if mesh.rank == who:
        time.sleep(600)
    return mesh.rank


def gemma_pipeline_rank(mesh, first, seed, xs_seed, n_micro, seq_len):
    """Layers first.. (one a stage) of gemma3-12b at full widths through a
    pipeline of the mesh's stages on the card: outputs (last stage), the
    gradient of mean(out²) for this stage's layer, K7-K9 launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import spmd_pipeline_fn
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import pipeline_block, pipeline_stage

    cfg = get_config("gemma3-12b")
    S, s = mesh.shape["stage"], mesh.axis_index("stage")
    stack = pipeline_stage(cfg, first + s, first + s + 1, 1, seed,
                           mesh.device)
    g = torch.Generator(mesh.device).manual_seed(xs_seed)
    xs = torch.randn((n_micro, 1, seq_len, cfg.d_model), generator=g,
                     device=mesh.device).bfloat16()
    fa.reset_launches()
    weights = tree_map(lambda a: a.requires_grad_(True), stack["block"])
    out = spmd_pipeline_fn(pipeline_block(cfg), S)(
        stack, torch.ones(S, dtype=torch.int32), xs)
    (out.float() ** 2).mean().backward()
    return {"out": out.detach() if s == S - 1 else None,
            "grad": tree_map(lambda a: a.grad[0, 0], weights),
            "launches": dict(fa.LAUNCHES),
            "routes": {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()}}


def tp_serve_rank(mesh, cfg, params, ids, steps, pins=None):
    """Tensor-parallel serving of ``cfg`` on the mesh's model axis from a
    params tree held whole: each leaf's local and global shape and its
    spec, the prefill step's logits, the cache filled by ``LM.prefill``,
    the decode step's logits for each of ``steps`` [B, n] tokens
    (teacher-forced), this rank's cache shards with their bounds, and its
    K7 launches by route.  ``pins``: a moe config's routing to pin
    (:class:`PinRouting`; phases "p0" for the prefill step, "fill" for
    ``LM.prefill``, "dec<j>" for decode step j), and the rank's own
    choices returned under ``"own"``."""
    from repro_torch.core.spmd_pipeline import is_dtensor, local_bounds
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers, moe

    fa.reset_launches()
    pin = PinRouting(pins)
    if pins is not None:
        moe.ROUTING_HOOK = pin
    try:
        sharded = TS.distribute_params(mesh, tree_map(
            lambda a: a.to(mesh.device), params))
        specs = TS.param_shardings_serving(mesh, params)
        shapes = {}
        TS.map_with_path(lambda p, a: shapes.__setitem__(
            TS.path_str(p), (tuple(a.to_local().shape), tuple(a.shape))),
            sharded)
        spec_of = {}
        TS.map_with_path(lambda p, sh: spec_of.__setitem__(
            TS.path_str(p), tuple(sh.spec)), specs)
        ids = ids.to(mesh.device)
        model, pre = TST.make_prefill_step(cfg, mesh)
        pin.phase = "p0"
        logits = pre(sharded, {"ids": ids})
        S, n = ids.shape[1], steps.shape[1]
        cache = TST.init_cache_sharded(cfg, mesh, ids.shape[0], S + n)
        pin.phase = "fill"
        model.prefill(sharded, ids, cache)
        _, dec = TST.make_decode_step(cfg, mesh)
        dec_logits = []
        for j in range(n):
            pin.phase = f"dec{j}"
            lg, cache = dec(sharded, cache,
                            {"ids": steps[:, j:j + 1].to(mesh.device),
                             "pos": S + j})
            dec_logits.append(lg.cpu())
        shards = {}
        TS.map_with_path(lambda p, a: shards.__setitem__(
            TS.path_str(p), (a.to_local().cpu(), local_bounds(a),
                             tuple(a.shape))), cache)
        return {"shapes": shapes, "specs": spec_of,
                "logits": logits.cpu(), "decode": dec_logits,
                "cache": shards,
                "all_dtensors": all(is_dtensor(a)
                                    for a in leaves(sharded)),
                "k7_routes": dict(fa.ROUTE_LAUNCHES["flash_attention"]),
                "own": pin.own}
    finally:
        moe.ROUTING_HOOK = None
        layers.set_attention_mesh(None)


def tp_init_rank(mesh, cfg, moe_cfg, seed):
    """``distribute_params`` of a whole draw: each leaf's local tensor is
    the whole leaf at its ``local_bounds``, contiguous, and nothing else;
    ``init_cache_sharded``'s local shapes; the same of a moe config (its
    experts split over the model axis); the refusals: the serve step's of
    a data axis over more than one rank (the dense and the moe config), and
    K7's of a DTensor (its plain version must not take one)."""
    from repro_torch.core.spmd_pipeline import local_bounds
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    def gen():
        return torch.Generator(mesh.device).manual_seed(seed)

    def cut(c):
        whole = LM(c).init(gen())
        drawn = TS.distribute_params(mesh, whole)
        same = all(torch.equal(d.to_local(), w[local_bounds(d)])
                   and d.to_local().is_contiguous() and d.shape == w.shape
                   for d, w in zip(leaves(drawn), leaves(whole)))
        return drawn, same

    def local_shapes(tree):
        out = {}
        TS.map_with_path(lambda p, a: out.__setitem__(
            TS.path_str(p), tuple(a.to_local().shape)), tree)
        return out

    drawn, same = cut(cfg)
    moe_drawn, moe_same = cut(moe_cfg)
    cache = TST.init_cache_sharded(cfg, mesh, 4, 16)
    shapes = local_shapes(cache)
    ids = torch.zeros((4, 8), dtype=torch.long)
    from repro_torch.kernels import ops

    q = TS.to_dtensor(mesh, torch.zeros((2, 4, 2, 16)),
                      TS.P(None, None, "model", None), (2, 4, 4, 16))
    refused = {}
    try:
        ops.attention(q, q, q, True, 0)
        refused["dtensor_kernel"] = ""
    except TypeError as e:
        refused["dtensor_kernel"] = str(e)
    try:
        for key, c, p in (("data_refused", cfg, drawn),
                          ("moe_data_refused", moe_cfg, moe_drawn)):
            try:
                TST.make_prefill_step(c, mesh)[1](p, {"ids": ids})
                refused[key] = ""
            except NotImplementedError as e:
                refused[key] = str(e)
    finally:
        layers.set_attention_mesh(None)
    moe_cache = TST.init_cache_sharded(moe_cfg, mesh, 4, 16)
    return {"shards_of_whole_draw": same and moe_same,
            "cache_shapes": shapes,
            "cache_zero": all(not a.to_local().any() for a in leaves(cache)),
            "moe_shapes": local_shapes(moe_drawn),
            "moe_cache_shapes": local_shapes(moe_cache), **refused}


def _shards(tree) -> dict:
    """path → (this rank's local tensor, its bounds, the global shape) of
    every leaf of ``tree`` (a plain leaf is a whole shard)."""
    from repro_torch.core.spmd_pipeline import local_bounds, local_tensor
    from repro_torch.launch import sharding as TS

    out = {}
    TS.map_with_path(lambda p, a: out.__setitem__(
        TS.path_str(p), (local_tensor(a).detach().cpu().clone(),
                         local_bounds(a), tuple(a.shape))), tree)
    return out


def tp_train_rank(mesh, cfg, params, batch, batches, kw, audio=None,
                  odd=None):
    """Tensor-parallel training of ``cfg`` on the mesh's model axis from a
    params tree held whole, with ``seq_parallel`` on and off: the loss and
    this rank's gradient shards of ``loss_and_grads`` on ``batch`` (the
    constraints ``make_train_step`` uses), whether every gradient is a
    DTensor laid out as its param, then one ``make_train_step`` step a
    batch of ``batches`` from the same start (metrics, the params' and
    moments' shards, the moments' placements equal to the params').  Also
    a whole optimizer state through ``distribute_params`` by
    ``opt_shardings``, the replicated-leaf rule on a 3-element leaf (each rank's use weighted
    by its rank + 1), the train step's refusal of ``scan_chunks``, and,
    given ``audio`` (cfg, params, embeds, step embeds, batch), tensor-
    parallel serving and training of that config; given ``odd``, a batch
    whose length the model axis does not divide, its loss and gradient
    shards with ``seq_parallel`` (the guard leaves the carry whole)."""
    from repro_torch.core.spmd_pipeline import (is_dtensor, local_bounds,
                                                local_tensor)
    from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers
    from repro_torch.optim import AdamWState

    def grads_of(c, p, b, sp, loss_chunk):
        state = TST.init_train_state_sharded(c, mesh, p)
        con = layers.SeqParallel(mesh) if sp else None
        layers.set_attention_mesh(mesh)
        ce, grads, _ = TST.loss_and_grads(
            LM(c), state["params"], b, act_constraint=con,
            param_constraint=TST._layer_param_constraint(mesh),
            loss_chunk=loss_chunk)
        flat = leaves(state["params"])
        laid_out = all(is_dtensor(g) and g.placements == q.placements
                       and g.shape == q.shape for g, q in zip(grads, flat))
        tree = unflatten(flatten(state["params"])[1], grads)
        return float(ce), _shards(tree), laid_out

    out: dict = {"loss": {}, "grads": {}, "laid_out": {}, "steps": {}}
    try:
        for sp in (True, False):
            (out["loss"][sp], out["grads"][sp],
             out["laid_out"][sp]) = grads_of(cfg, params, batch, sp,
                                             kw["loss_chunk"])
            _, step = TST.make_train_step(cfg, mesh, seq_parallel=sp, **kw)
            state = TST.init_train_state_sharded(cfg, mesh, params)
            mets = []
            for b in batches:
                state, met = step(state, b)
                mets.append({k: float(v) for k, v in met.items()})
            opt = state["opt"]
            out["steps"][sp] = {
                "metrics": mets, "params": _shards(state["params"]),
                "m": _shards(opt.m), "v": _shards(opt.v),
                "step": int(opt.step), "step_plain": not is_dtensor(opt.step),
                "moments_laid_out": all(
                    m.placements == p.placements == v.placements
                    for m, v, p in zip(leaves(opt.m), leaves(opt.v),
                                       leaves(state["params"])))}
        # a whole optimizer state laid out by opt_shardings: each rank's
        # moments are the whole ones at its bounds, the step a plain tensor
        whole = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                           m=tree_map(lambda a: a * 2, params),
                           v=tree_map(lambda a: a * a, params))
        opt = TS.distribute_params(mesh, whole,
                                   TS.opt_shardings(mesh, whole, params))
        out["opt_distributed"] = not is_dtensor(opt.step) and all(
            is_dtensor(d) and torch.equal(local_tensor(d), w[local_bounds(d)])
            for d, w in zip(leaves(opt.m) + leaves(opt.v),
                            leaves(whole.m) + leaves(whole.v)))
        # the rule: a leaf every rank holds whole, its use split or not
        w = TS.to_dtensor(mesh, torch.ones(3, device=mesh.device), TS.P(),
                          (3,)).requires_grad_()
        x = torch.full((3,), float(mesh.rank + 1), device=mesh.device)
        out["rule"] = {}
        for split in (True, False):
            with torch.enable_grad():
                y = (layers._local(w, split) * x).sum()
                (g,) = torch.autograd.grad(y, [w])
            out["rule"][split] = local_tensor(g).cpu()
        try:
            _, step = TST.make_train_step(cfg, mesh, scan_chunks=2, **kw)
            step(TST.init_train_state_sharded(cfg, mesh, params), batch)
            out["scan_refused"] = ""
        except NotImplementedError as e:
            out["scan_refused"] = str(e)
        if audio is not None:
            out["audio"] = _tp_audio(mesh, *audio, grads_of=grads_of)
        if odd is not None:
            out["odd"] = grads_of(cfg, params, odd, True, kw["loss_chunk"])
    finally:
        layers.set_attention_mesh(None)
    return out


def _tp_audio(mesh, cfg, params, embeds, steps, batch, *, grads_of):
    """The audio family (``embeds_in``) under the model axis: the prefill
    step's logits, the decode step's for each of ``steps`` [B, n, d]
    embeddings after ``LM.prefill``, and the loss and gradient shards of
    the train step's ``loss_and_grads`` (sequence parallel)."""
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST

    sharded = TS.distribute_params(mesh, params)
    model, pre = TST.make_prefill_step(cfg, mesh)
    logits = pre(sharded, {"embeds": embeds})
    S, n = embeds.shape[1], steps.shape[1]
    cache = TST.init_cache_sharded(cfg, mesh, embeds.shape[0], S + n)
    model.prefill(sharded, None, cache, embeds=embeds)
    _, dec = TST.make_decode_step(cfg, mesh)
    dec_logits = []
    for j in range(n):
        lg, cache = dec(sharded, cache, {"embeds": steps[:, j:j + 1],
                                         "pos": S + j})
        dec_logits.append(lg)
    loss, grads, laid_out = grads_of(cfg, params, batch, True, 8)
    return {"logits": logits, "decode": dec_logits, "loss": loss,
            "grads": grads, "laid_out": laid_out}


def tp_refusal_rank(mesh, cfgs, cfg, seed, batch):
    """On a mesh with a data axis over more than one rank: the train
    step's refusal of each of ``cfgs``' families and of ``cfg`` (a dense
    config) for the data axis; each message, or "" if it ran; and of
    each config's params and moments (``adamw_init`` of the params by
    ``param_shardings``), their local shapes by path (``"shapes"``)."""
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers
    from repro_torch.optim import adamw_init

    out = {"shapes": {}}
    try:
        for c in (*cfgs, cfg):
            whole = LM(c).init(torch.Generator().manual_seed(seed))
            params = TS.distribute_params(mesh, whole,
                                          TS.param_shardings(mesh, whole))
            opt = adamw_init(params)
            shapes = out["shapes"][c.arch_id] = {}
            for name, tree in (("params", params), ("m", opt.m),
                               ("v", opt.v)):
                TS.map_with_path(lambda p, a, n=name: shapes.__setitem__(
                    f"{n}/{TS.path_str(p)}", tuple(a.to_local().shape)),
                    tree)
            _, step = TST.make_train_step(c, mesh)
            try:
                step({"params": params, "opt": opt}, batch)
                out[c.arch_id] = ""
            except NotImplementedError as e:
                out[c.arch_id] = str(e)
    finally:
        layers.set_attention_mesh(None)
    return out


class PinRouting:
    """A ``moe.ROUTING_HOOK`` that pins each moe layer's top-k choices to
    ``choices[phase][layer]`` ([G, Ng, k] indices; the caller sets
    ``phase`` before each call) and keeps the rank's own choices, before
    pinning, by (phase, layer) in ``own``.  ``choices`` None: nothing is
    pinned.  A layer's router is a view of the stacked ``[L, d, E]`` one,
    so its storage offset names the layer (0 for one layer alone)."""

    def __init__(self, choices=None):
        self.choices, self.phase, self.own = choices, None, {}

    def __call__(self, router, logits, idx):
        layer = router.storage_offset() // router.numel()
        self.own.setdefault((self.phase, layer), []).append(
            idx.detach().cpu().clone())
        if self.choices is None:
            return idx
        return torch.as_tensor(self.choices[self.phase][layer],
                               dtype=torch.long, device=idx.device)


def _ep_grads(mesh, cfg, params, batch, sp, weights, loss_chunk):
    """Expert-parallel training's loss and gradient shards on ``batch``
    from a params tree held whole: ``weights`` None is the train step's
    own ``loss_and_grads`` (cross-entropy plus 1e-2 x load balance plus
    1e-3 x router z), else (w_ce, w_lb, w_z) weight the three terms of the
    loss differentiated (the same forward and constraints) → (the loss
    differentiated, the gradient shards, every gradient a DTensor laid
    out as its param, the aux values)."""
    from repro_torch.core.spmd_pipeline import (is_dtensor, like_dtensor,
                                                local_tensor)
    from repro_torch.core.tree import flatten, leaves, unflatten
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    state = TST.init_train_state_sharded(cfg, mesh, params)
    con = layers.SeqParallel(mesh) if sp else None
    pcon = TST._layer_param_constraint(mesh)
    layers.set_attention_mesh(mesh)
    model, p = LM(cfg), state["params"]
    flat = leaves(p)
    if weights is None:
        loss, grads, aux = TST.loss_and_grads(
            model, p, batch, act_constraint=con, param_constraint=pcon,
            loss_chunk=loss_chunk)
        loss = aux["total"]
    else:
        try:
            with torch.enable_grad():
                for a in flat:
                    a.requires_grad_(True)
                h, aux = model.apply(p, batch["ids"], act_constraint=con,
                                     param_constraint=pcon)
                ce = model.loss(p, h, batch["labels"], batch["mask"],
                                chunk=loss_chunk)
                loss = (weights[0] * ce
                        + weights[1] * aux["load_balance_loss"]
                        + weights[2] * aux["router_z_loss"])
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for a in flat:
                a.requires_grad_(False)
        grads = [like_dtensor(torch.zeros_like(local_tensor(a)), a)
                 if g is None else g for a, g in zip(flat, grads)]
    laid_out = all(is_dtensor(g) and g.placements == a.placements
                   and g.shape == a.shape for g, a in zip(grads, flat))
    return (float(loss), _shards(unflatten(flatten(p)[1], grads)), laid_out,
            {k: float(v) for k, v in aux.items()})


def _moe_grads(w, x, top_k, cf, groups, mode) -> dict:
    """The gradient of sum(y²) of ``moe_apply`` for ``x`` (whole on every
    rank) and the router, ``wi`` and ``wo`` (their shards) → name →
    (local tensor, bounds, global shape)."""
    from repro_torch.models import moe

    x = x.clone().requires_grad_(True)
    names = ("router", "wi", "wo")
    try:
        with torch.enable_grad():
            for n in names:
                w[n].requires_grad_(True)
            y, _ = moe.moe_apply(w, x, top_k, cf, groups, mode)
            grads = torch.autograd.grad((y * y).sum(),
                                        [x] + [w[n] for n in names])
    finally:
        for n in names:
            w[n].requires_grad_(False)
    return _shards(dict(zip(("x",) + names, grads)))


def ep_rank(mesh, job):
    """Expert parallelism of a moe config on the mesh's model axis, each
    run with the reference's routing pinned (:class:`PinRouting`):
    ``moe_apply`` on one layer's weights by ``param_shardings_serving``
    (each dispatch of ``job["moe_cases"]``) and its gradients; given
    ``job["serve"]``, the prefill step, ``LM.prefill`` into a sharded cache
    and teacher-forced decode steps; the loss and gradient shards of the
    train step's ``loss_and_grads`` with ``seq_parallel`` on and off, and
    of the aux terms alone and of the cross-entropy alone (the gates'
    path); two
    ``make_train_step`` steps from the same start; given ``job["guard"]``
    (a config whose experts the axis does not divide, its params, pins),
    its prefill logits and gradients; an unpinned prefill; and the rank's
    own choices in every run."""
    from repro_torch.core.spmd_pipeline import is_dtensor
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers, moe

    cfg, params, kw = job["cfg"], job["params"], job["kw"]
    chunk = kw["loss_chunk"]
    pin = PinRouting(job["pins"])
    moe.ROUTING_HOOK = pin
    out: dict = {"moe": {}, "grads": {}, "steps": {}}
    try:
        w = TS.distribute_params(mesh, {"moe": job["moe_w"]})["moe"]
        for mode, groups in job["moe_cases"]:
            pin.phase = f"moe_{mode}"
            routing = {}
            y, aux = moe.moe_apply(w, job["moe_x"], job["moe_k"],
                                   job["moe_cf"], groups, mode,
                                   routing=routing)
            out["moe"][mode] = {
                "y": y, "aux": {k: float(v) for k, v in aux.items()},
                "G": routing["G"], "C": routing["C"],
                "wi": tuple(w["wi"].to_local().shape),
                "wo": tuple(w["wo"].to_local().shape),
                "grads": _moe_grads(w, job["moe_x"], job["moe_k"],
                                    job["moe_cf"], groups, mode)}
        ids = job["batches"][0]["ids"]
        if job.get("serve") is not None:
            sharded = TS.distribute_params(mesh, params)
            shapes = {}
            TS.map_with_path(lambda p, a: shapes.__setitem__(
                TS.path_str(p), tuple(a.to_local().shape)), sharded)
            model, pre = TST.make_prefill_step(cfg, mesh)
            pin.phase = "p0"
            logits = pre(sharded, {"ids": ids})
            steps = job["serve"]
            S, n = ids.shape[1], steps.shape[1]
            cache = TST.init_cache_sharded(cfg, mesh, ids.shape[0], S + n)
            pin.phase = "fill"
            model.prefill(sharded, ids, cache)
            _, dec = TST.make_decode_step(cfg, mesh)
            dec_logits = []
            for j in range(n):
                pin.phase = f"dec{j}"
                lg, cache = dec(sharded, cache, {"ids": steps[:, j:j + 1],
                                                 "pos": S + j})
                dec_logits.append(lg)
            out["serve"] = {"logits": logits, "decode": dec_logits,
                            "cache": _shards(cache), "shapes": shapes}
        for sp in (True, False):
            pin.phase = "p0"
            out["grads"][sp] = {
                part: _ep_grads(mesh, cfg, params, job["batches"][0], sp,
                                weights, chunk)
                for part, weights in (("total", None),
                                      ("aux", (0.0, 1e-2, 1e-3)),
                                      ("gate", (1.0, 0.0, 0.0)))}
            _, step = TST.make_train_step(cfg, mesh, seq_parallel=sp, **kw)
            state = TST.init_train_state_sharded(cfg, mesh, params)
            mets = []
            for i, b in enumerate(job["batches"]):
                pin.phase = f"p{i}"
                state, met = step(state, b)
                mets.append({k: float(v) for k, v in met.items()})
            opt = state["opt"]
            out["steps"][sp] = {
                "metrics": mets, "params": _shards(state["params"]),
                "m": _shards(opt.m), "v": _shards(opt.v),
                "step_plain": not is_dtensor(opt.step),
                "moments_laid_out": all(
                    m.placements == p.placements == v.placements
                    for m, v, p in zip(leaves(opt.m), leaves(opt.v),
                                       leaves(state["params"])))}
        if job.get("guard") is not None:
            gcfg, gparams = job["guard"]
            sharded = TS.distribute_params(mesh, gparams)
            _, pre = TST.make_prefill_step(gcfg, mesh)
            pin.phase = "g0"
            out["guard"] = {
                "logits": pre(sharded, {"ids": ids}),
                "wi": tuple(sharded["layers"]["moe"]["wi"].to_local().shape),
                "grads": _ep_grads(mesh, gcfg, gparams, job["batches"][0],
                                   True, None, chunk)}
        # the ranks' own choices, nothing pinned
        pin.choices, pin.phase = None, "own"
        _, pre = TST.make_prefill_step(cfg, mesh)
        pre(TS.distribute_params(mesh, params), {"ids": ids})
    finally:
        moe.ROUTING_HOOK = None
        layers.set_attention_mesh(None)
    out["own"] = pin.own
    return out
