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


def tp_serve_rank(mesh, cfg, params, ids, steps, pins=None, img=None):
    """Tensor-parallel serving of ``cfg`` on the mesh's model axis from a
    params tree held whole: each leaf's local and global shape and its
    spec, the prefill step's logits, the cache filled by ``LM.prefill``,
    the decode step's logits for each of ``steps`` [B, n] tokens
    (teacher-forced), this rank's cache shards with their bounds, and its
    K7 launches by route.  ``pins``: a moe config's routing to pin
    (:class:`PinRouting`; phases "p0" for the prefill step, "fill" for
    ``LM.prefill``, "dec<j>" for decode step j), and the rank's own
    choices returned under ``"own"``.  ``img``: a vlm config's image
    embeddings [B, M, d], given to the prefill step and ``LM.prefill``."""
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
        kw = {} if img is None else {"img_embeds": img.to(mesh.device)}
        model, pre = TST.make_prefill_step(cfg, mesh)
        pin.phase = "p0"
        logits = pre(sharded, {"ids": ids, **kw})
        S, n = ids.shape[1], steps.shape[1]
        cache = TST.init_cache_sharded(cfg, mesh, ids.shape[0], S + n)
        pin.phase = "fill"
        model.prefill(sharded, ids, cache, **kw)
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


def tp_init_rank(mesh, cfg, moe_cfg, vlm_cfg, seed):
    """``distribute_params`` of a whole draw: each leaf's local tensor is
    the whole leaf at its ``local_bounds``, contiguous, and nothing else;
    ``init_cache_sharded``'s local shapes; the same of a moe config (its
    experts split over the model axis) and of ``vlm_cfg`` (its ``[G, per,
    ...]`` self layers and ``{"self", "cross"}`` cache); the serve step
    on a data axis over more than one rank (each config's refusal, or ""
    where it ran; the vlm config's against zero image embeddings), and
    K7's refusal of a DTensor (its plain version must not take one)."""
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
    vlm_drawn, vlm_same = cut(vlm_cfg)
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
                          ("moe_data_refused", moe_cfg, moe_drawn),
                          ("vlm_data_refused", vlm_cfg, vlm_drawn)):
            kw = ({"img_embeds": torch.zeros((4, c.n_img_tokens, c.d_model))}
                  if c.cross_attn_every else {})
            try:
                TST.make_prefill_step(c, mesh)[1](p, {"ids": ids, **kw})
                refused[key] = ""
            except NotImplementedError as e:
                refused[key] = str(e)
    finally:
        layers.set_attention_mesh(None)
    moe_cache = TST.init_cache_sharded(moe_cfg, mesh, 4, 16)
    vlm_cache = TST.init_cache_sharded(vlm_cfg, mesh, 4, 16)
    return {"shards_of_whole_draw": same and moe_same and vlm_same,
            "cache_shapes": shapes,
            "cache_zero": all(not a.to_local().any() for a in
                              leaves(cache) + leaves(vlm_cache)),
            "moe_shapes": local_shapes(moe_drawn),
            "moe_cache_shapes": local_shapes(moe_cache),
            "vlm_shapes": local_shapes(vlm_drawn),
            "vlm_cache_shapes": local_shapes(vlm_cache), **refused}


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


def _grads_of(mesh, cfg, params, batch, sp, loss_chunk):
    """The loss and this rank's gradient shards of ``loss_and_grads`` on
    ``batch`` from a params tree held whole (the constraints
    ``make_train_step`` uses; ``sp``: seq_parallel), and whether every
    gradient is a DTensor laid out as its param."""
    from repro_torch.core.spmd_pipeline import is_dtensor
    from repro_torch.core.tree import flatten, leaves, unflatten
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    state = TST.init_train_state_sharded(cfg, mesh, params)
    con = layers.SeqParallel(mesh) if sp else None
    layers.set_attention_mesh(mesh)
    ce, grads, _ = TST.loss_and_grads(
        LM(cfg), state["params"], batch, act_constraint=con,
        param_constraint=TST._layer_param_constraint(mesh),
        loss_chunk=loss_chunk)
    flat = leaves(state["params"])
    laid_out = all(is_dtensor(g) and g.placements == q.placements
                   and g.shape == q.shape for g, q in zip(grads, flat))
    tree = unflatten(flatten(state["params"])[1], grads)
    return float(ce), _shards(tree), laid_out


def _train_steps(mesh, cfg, params, batches, kw, sp, opt=None,
                 pin=None, first: int = 0) -> dict:
    """One ``make_train_step`` step a batch of ``batches`` from a params
    tree held whole (``sp``: seq_parallel), and from ``opt``, a whole
    optimizer state laid out by ``opt_shardings`` (fresh moments when
    None): the metrics, the params' and moments' shards, and the moments'
    placements equal to the params'.  ``pin``: a :class:`PinRouting` whose
    phase is ``p<first + i>`` for the i-th step here."""
    from repro_torch.core.spmd_pipeline import is_dtensor
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST

    _, step = TST.make_train_step(cfg, mesh, seq_parallel=sp, **kw)
    state = TST.init_train_state_sharded(cfg, mesh, params)
    if opt is not None:
        state["opt"] = TS.distribute_params(
            mesh, opt, TS.opt_shardings(mesh, opt, params))
    mets = []
    for i, b in enumerate(batches):
        if pin is not None:
            pin.phase = f"p{first + i}"
        state, met = step(state, b)
        mets.append({k: float(v) for k, v in met.items()})
    opt = state["opt"]
    return {"metrics": mets, "params": _shards(state["params"]),
            "m": _shards(opt.m), "v": _shards(opt.v),
            "step": int(opt.step), "step_plain": not is_dtensor(opt.step),
            "moments_laid_out": all(
                m.placements == p.placements == v.placements
                for m, v, p in zip(leaves(opt.m), leaves(opt.v),
                                   leaves(state["params"])))}


def tp_train_rank(mesh, cfg, params, batch, batches, kw, audio=None,
                  odd=None, whole_heads=None):
    """Tensor-parallel training of ``cfg`` on the mesh's model axis from a
    params tree held whole, with ``seq_parallel`` on and off: the loss and
    this rank's gradient shards of ``loss_and_grads`` on ``batch``
    (:func:`_grads_of`), then one ``make_train_step`` step a batch of
    ``batches`` from the same start (:func:`_train_steps`).  Also a whole
    optimizer state through ``distribute_params`` by ``opt_shardings``,
    the replicated-leaf rule on a 3-element leaf (each rank's use weighted
    by its rank + 1), the train step at ``scan_chunks`` 2 against 0
    (:func:`_scan_steps`), and,
    given ``audio`` (cfg, params, embeds, step embeds, batch), tensor-
    parallel serving and training of that config; given ``odd``, a batch
    whose length the model axis does not divide, its loss and gradient
    shards with ``seq_parallel`` (the guard leaves the carry whole); given
    ``whole_heads`` (cfg, params, batch), that config's loss and gradient
    shards with ``seq_parallel`` on and off, as for ``cfg``."""
    import functools

    from repro_torch.core.spmd_pipeline import (is_dtensor, local_bounds,
                                                local_tensor)
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.launch import sharding as TS
    from repro_torch.models import layers
    from repro_torch.optim import AdamWState

    grads_of = functools.partial(_grads_of, mesh)
    out: dict = {"loss": {}, "grads": {}, "laid_out": {}, "steps": {}}
    try:
        for sp in (True, False):
            (out["loss"][sp], out["grads"][sp],
             out["laid_out"][sp]) = grads_of(cfg, params, batch, sp,
                                             kw["loss_chunk"])
            out["steps"][sp] = _train_steps(mesh, cfg, params, batches, kw,
                                            sp)
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
        out["scan"] = _scan_steps(mesh, cfg, params, batch)
        if audio is not None:
            out["audio"] = _tp_audio(mesh, *audio, grads_of=grads_of)
        if odd is not None:
            out["odd"] = grads_of(cfg, params, odd, True, kw["loss_chunk"])
        if whole_heads is not None:
            wh = out["whole_heads"] = {"loss": {}, "grads": {},
                                       "laid_out": {}}
            for sp in (True, False):
                (wh["loss"][sp], wh["grads"][sp],
                 wh["laid_out"][sp]) = grads_of(*whole_heads, sp,
                                                kw["loss_chunk"])
    finally:
        layers.set_attention_mesh(None)
    return out


def tp_family_rank(mesh, jobs, kw):
    """The hybrid, ssm and vlm families under the mesh's model axis, for
    each job of ``jobs`` (name → (cfg, params held whole, prompt ids [B,
    S], teacher-forced decode tokens [B, n], a train batch, the two train
    steps' batches, the (params, optimizer state) to start the second step
    from, and for a vlm config its image embeddings [B, M, d], which the
    train batches hold too)): :func:`tp_serve_rank`'s serving run (the
    prefill step's logits, each decode step's, this rank's cache shards),
    and with ``seq_parallel`` on and off the loss and gradient shards
    (:func:`_grads_of`), the two train steps (:func:`_train_steps`), each
    from its own start, and the two steps carried on from the first
    (``"carried"``)."""
    from repro_torch.models import layers

    out = {}
    try:
        for name, job in jobs.items():
            cfg, params, ids, steps, batch, batches, (mid, opt), *img = job
            img = img[0] if img else None
            r = out[name] = {"serve": tp_serve_rank(mesh, cfg, params, ids,
                                                    steps, img=img),
                             "loss": {}, "grads": {}, "laid_out": {},
                             "steps": {}, "carried": {}}
            for sp in (True, False):
                (r["loss"][sp], r["grads"][sp],
                 r["laid_out"][sp]) = _grads_of(mesh, cfg, params, batch, sp,
                                                kw["loss_chunk"])
                r["steps"][sp] = [
                    _train_steps(mesh, cfg, params, batches[:1], kw, sp),
                    _train_steps(mesh, cfg, mid, batches[1:], kw, sp, opt)]
                r["carried"][sp] = _train_steps(mesh, cfg, params, batches,
                                                kw, sp)
            if cfg.cross_attn_every:
                r["unstack"] = _unstack_probe(mesh, cfg, params)
    finally:
        layers.set_attention_mesh(None)
    return out


def _unstack_probe(mesh, cfg, params) -> dict:
    """Whether ``_unstack(tree, 2)`` of the vlm self layers' DTensor
    weights (serving layout) and of the sharded self cache gives, in the
    order g * per + j, DTensors of the layer's shape and bounds whose local
    tensors are views of the stack's local tensor at [g, j]."""
    from repro_torch.core.spmd_pipeline import is_dtensor, local_bounds
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models.transformer import _unstack

    trees = {"params": TS.distribute_params(mesh, params)["layers"],
             "cache": TST.init_cache_sharded(cfg, mesh, 2, 4)["self"]}
    out = {}
    for name, tree in trees.items():
        stack = leaves(tree)
        G, per = stack[0].shape[:2]
        layers = _unstack(tree, 2)
        ok = len(layers) == G * per
        for i, lp in enumerate(layers):
            g, j = divmod(i, per)
            for a, st in zip(leaves(lp), stack):
                ok = ok and (
                    is_dtensor(a) and a.shape == st.shape[2:]
                    and local_bounds(a) == local_bounds(st)[2:]
                    and a.to_local().data_ptr()
                    == st.to_local()[g, j].data_ptr()
                    and a.to_local().shape == st.to_local()[g, j].shape)
        out[name] = bool(ok)
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
    config) for the data axis; each message, or "" if it ran (a vlm
    config's batch with zero image embeddings); and of each config's
    params and moments (``adamw_init`` of the params by
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
            b = ({**batch, "img_embeds": torch.zeros(
                (batch["ids"].shape[0], c.n_img_tokens, c.d_model))}
                 if c.cross_attn_every else batch)
            try:
                step({"params": params, "opt": opt}, b)
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
    so its storage offset names the layer (0 for one layer alone).
    ``part`` (i, n): the rank holds the i-th of n equal parts of the
    global batch's tokens (its rows of a batch split over a data axis), so
    it takes that part of the global choices."""

    def __init__(self, choices=None):
        self.choices, self.phase, self.own = choices, None, {}
        self.part = None

    def __call__(self, router, logits, idx):
        layer = router.storage_offset() // router.numel()
        self.own.setdefault((self.phase, layer), []).append(
            idx.detach().cpu().clone())
        if self.choices is None:
            return idx
        chosen = torch.as_tensor(self.choices[self.phase][layer],
                                 dtype=torch.long, device=idx.device)
        if self.part is not None:
            i, n = self.part
            flat = chosen.reshape(-1, chosen.shape[-1])
            m = flat.shape[0] // n
            chosen = flat[i * m:(i + 1) * m]
        return chosen.reshape(idx.shape)


def _batch_part(mesh) -> tuple:
    """(i, n): this rank holds the i-th of the n equal parts of a batch
    split over the mesh's batch axes, ``pod`` and ``data`` (pod-major)."""
    i, n = 0, 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            i, n = i * mesh.shape[a] + mesh.axis_index(a), n * mesh.shape[a]
    return i, n


def _ep_grads(mesh, cfg, params, batch, sp, weights, loss_chunk,
              scan_chunks=0):
    """Expert-parallel training's loss and gradient shards on ``batch``
    from a params tree held whole: ``weights`` None is the train step's
    own ``loss_and_grads`` (cross-entropy plus 1e-2 x load balance plus
    1e-3 x router z; its layers checkpointed in chunks of ``scan_chunks``
    too), else (w_ce, w_lb, w_z) weight the three terms of the loss
    differentiated (the same forward and constraints) → (the loss
    differentiated, the gradient shards, every gradient a DTensor laid
    out as its param, the aux values)."""
    from repro_torch.core.spmd_pipeline import (batch_line, is_dtensor,
                                                like_dtensor, local_tensor)
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
            loss_chunk=loss_chunk, scan_chunks=scan_chunks)
        loss = aux["total"]
    else:
        try:
            with torch.enable_grad():
                for a in flat:
                    a.requires_grad_(True)
                kw = ({"embeds": batch["embeds"]} if cfg.embeds_in
                      else {})
                h, aux = model.apply(p, batch.get("ids"), act_constraint=con,
                                     param_constraint=pcon, **kw)
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
        if batch_line(batch["labels"]) is not None:   # the train step's rule
            TST._sum_over_batch(flat, grads, batch_line(batch["labels"]))
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


def _fsdp_serve(mesh, cfg, params, job, layout, pin) -> dict:
    """Serving across a (data, model) mesh: the params by
    ``param_shardings_serving`` (``layout`` "serving") or
    ``param_shardings`` ("fsdp"), the prompt split over the data axis by
    ``distribute_batch``; the prefill step's logits, ``LM.prefill`` into a
    sharded cache, and the decode step's logits for each teacher-forced
    token of ``job["dec"]``: each as (local tensor, bounds, global
    shape), the logits also read whole by ``collect_batch``; the cache's
    shards; whether the logits are DTensors split over the data axis
    exactly when the batch is.  A vlm config's prompt is served against
    ``job["img"]`` [B, M, d], split by ``distribute_batch`` as the
    prompt is."""
    from repro_torch.core.spmd_pipeline import batch_line, is_dtensor
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST

    shard = (TS.param_shardings_serving if layout == "serving"
             else TS.param_shardings)(mesh, params)
    p = TS.distribute_params(mesh, params, shard)
    key = "embeds" if cfg.embeds_in else "ids"
    whole = job["batches"][0][key]
    inp = TS.distribute_batch(mesh, {key: whole})[key]
    img = ({"img_embeds": TS.distribute_batch(
        mesh, {"img_embeds": job["img"]})["img_embeds"]}
        if cfg.cross_attn_every else {})
    model, pre = TST.make_prefill_step(cfg, mesh)
    pin.phase = "p0"
    logits = pre(p, {key: inp, **img})
    B, S, n = whole.shape[0], whole.shape[1], job["dec"].shape[1]
    cache = TST.init_cache_sharded(cfg, mesh, B, S + n)
    pin.phase = "fill"
    model.prefill(p, None if cfg.embeds_in else inp, cache,
                  **({"embeds": inp} if cfg.embeds_in else {}), **img)
    _, dec = TST.make_decode_step(cfg, mesh)
    decs, split = [], batch_line(inp) is not None
    laid_out = is_dtensor(logits) and (batch_line(logits) is not None) == split
    for j in range(n):
        pin.phase = f"dec{j}"
        tok = TS.distribute_batch(mesh, {key: job["dec"][:, j:j + 1]})[key]
        lg, cache = dec(p, cache, {key: tok, "pos": S + j})
        laid_out = laid_out and is_dtensor(lg) and (
            batch_line(lg) is not None) == split
        decs.append(_shards({"x": lg})["x"])
    return {"logits": _shards({"x": logits})["x"],
            "collected": TS.collect_batch(logits).cpu(), "decode": decs,
            "cache": _shards(cache), "laid_out": laid_out,
            "input_local": tuple(inp.to_local().shape)}


def _fsdp_moe_apply(mesh, job, pin) -> dict:
    """``moe_apply`` on one layer's weights (whole over the data axis) and
    x [B, T, d] split over it, for each (mode, G) of ``job["cases"]``:
    the output, aux, C and the gradient of sum(y²) (the global batch's)
    for x and the weights, the weights' summed over the data axis as the
    train step sums a leaf whole over it."""
    from repro_torch.core.spmd_pipeline import (batch_like, batch_line,
                                                like_dtensor, local_tensor,
                                                reduce_over_ranks)
    from repro_torch.launch import sharding as TS
    from repro_torch.models import moe

    w = TS.distribute_params(mesh, {"moe": job["w"]})["moe"]
    xb = TS.distribute_batch(mesh, {"x": job["x"]})["x"]
    data = batch_line(xb)
    names = ("router", "wi", "wo")
    out = {}
    for mode, groups in job["cases"]:
        pin.phase = f"moe_{mode}{groups}"
        routing = {}
        x = xb.to_local().clone().requires_grad_(True)
        try:
            with torch.enable_grad():
                for nm in names:
                    w[nm].requires_grad_(True)
                y, aux = moe.moe_apply(w, x, job["k"], job["cf"], groups,
                                       mode, routing=routing, data=data)
                gs = torch.autograd.grad((y * y).sum(), [x] + [w[nm] for nm
                                                            in names])
        finally:
            for nm in names:
                w[nm].requires_grad_(False)
        grads = {"x": batch_like(gs[0], xb)}
        for nm, g in zip(names, gs[1:]):
            grads[nm] = like_dtensor(reduce_over_ranks(
                local_tensor(g), *data, backward=True), g)
        out[f"{mode}{groups}"] = {
            "y": _shards({"y": batch_like(y.detach(), xb)})["y"],
            "aux": {k: float(v) for k, v in aux.items()},
            "G": routing["G"], "C": routing["C"], "grads": _shards(grads)}
    return out


def _same_ranks(mesh, shape, axes):
    """A layout of ``shape`` over ``axes`` on the ranks of ``mesh`` (a rank
    mesh of as many ranks): the rank mesh itself where the axes and shape
    are its own, else a record read as the sharding rules and the step
    builders read a mesh (``axis_names``, ``shape``, its own
    ``DeviceMesh``, ``device``, ``axis_index``).  A ``DeviceMesh`` is a
    collective: every rank builds the layouts in one order."""
    import types

    from repro_torch.launch import mesh as TMESH

    lay = TMESH.MeshLayout(tuple(shape), tuple(axes))
    if lay == mesh.layout:
        return mesh
    dm = lay.device_mesh(mesh.device.type)
    return types.SimpleNamespace(
        axis_names=lay.axis_names, shape=lay.shape, device_mesh=dm,
        device=mesh.device,
        axis_index=lambda a: dm.get_coordinate()[lay.axis_names.index(a)])


def _pod_prefill(mesh, cfg, whole, batch, axes=("pod", "model")) -> tuple:
    """The prefill step of ``cfg`` on a (pod 2, model 2) mesh of the ranks
    of ``mesh`` (or a (2, 2) mesh of other ``axes``: ``("stage",
    "model")``, whose ``stage`` splits nothing) — the params by
    ``param_shardings``, ``batch`` split over ``pod`` by
    ``distribute_batch`` — and on the whole params in this process: (its
    logits read whole by ``collect_batch``, the whole run's)."""
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers

    pod = _same_ranks(mesh, (2, 2), axes)
    p = TS.distribute_params(pod, whole, TS.param_shardings(pod, whole))
    try:
        got = TS.collect_batch(TST.make_prefill_step(cfg, pod)[1](
            p, TS.distribute_batch(pod, batch)))
    finally:
        layers.set_attention_mesh(None)
    return got, TST.make_prefill_step(cfg)[1](whole, batch)


def _scan_steps(mesh, cfg, whole, batch) -> tuple:
    """One ``make_train_step`` step of ``cfg`` on ``mesh`` from ``whole``
    (held whole) on ``batch`` (whole; split by ``distribute_batch``) at
    ``scan_chunks`` 2 and at 0: (whether the two give the same metrics,
    params and moments, bit for bit; the loss at 2)."""
    from repro_torch.launch import sharding as TS

    b = [TS.distribute_batch(mesh, batch)]
    one = {c: _train_steps(mesh, cfg, whole, b,
                           {"loss_chunk": 8, "scan_chunks": c}, True)
           for c in (2, 0)}
    return (one[0]["metrics"] == one[2]["metrics"] and all(
        torch.equal(x[0], y[0]) for n in ("params", "m", "v")
        for x, y in zip(one[0][n].values(), one[2][n].values())),
        one[2]["metrics"][0]["loss"])


def _fsdp_refusals(mesh, dense) -> dict:
    """What a (data, model) mesh runs beside its own layout, and what it
    refuses: ``dense`` on a (pod 2, model 2) and on a (stage 2, model 2)
    mesh of the same ranks, each prefill against the whole run's
    (``"pod"``, ``"stage"``: :func:`_pod_prefill`); the train step at
    ``scan_chunks`` 2 against 0 (``"scan_chunks"``: :func:`_scan_steps`);
    ``with_spec`` moving a dim split over ``data`` (which ``unshard``
    gathers instead; the message, "" where it ran); and a recurrent state
    whose rows of B are not the activations' (``"state_rows"``, the
    ValueError's message)."""
    from repro_torch.core.spmd_pipeline import batch_line, unshard, with_spec
    from repro_torch.launch import sharding as TS
    from repro_torch.models import LM, layers

    def refused(fn, error=NotImplementedError) -> str:
        try:
            fn()
        except error as e:
            return str(e)
        return ""

    out = {}
    toks = torch.arange(32).reshape(4, 8)
    try:
        whole = LM(dense).init(torch.Generator().manual_seed(7))
        out["pod"] = _pod_prefill(mesh, dense, whole,
                                  {"ids": toks * 7 % dense.vocab})
        out["stage"] = _pod_prefill(mesh, dense, whole,
                                    {"ids": toks * 5 % dense.vocab},
                                    ("stage", "model"))
        out["scan_chunks"] = _scan_steps(mesh, dense, whole, {
            "ids": toks * 3 % dense.vocab, "labels": toks * 11 % dense.vocab,
            "mask": torch.ones(toks.shape)})
        x = TS.to_dtensor(mesh, torch.arange(8.0).reshape(2, 4) + 8 * (
            mesh.axis_index("data")), TS.P("data", None), (4, 4))
        out["with_spec"] = refused(lambda: with_spec(x, TS.P(None, None)))
        out["with_spec_same"] = with_spec(x, TS.P("data", None)) is x
        g = unshard(x, "data", False)
        out["unshard"] = (tuple(g.to_local().shape), [q.is_replicate() for q
                                                      in g.placements],
                          bool(torch.equal(g.to_local(),
                                           torch.arange(16.0).reshape(4, 4))))
        # a recurrent state's rows against the activations': 2 rows of a
        # batch of 4 split over data, beside a state of 4 split the same
        # way, one of 4 split over data beside a whole batch of 2, and a
        # whole state of 2 beside the split batch
        line = batch_line(TS.to_dtensor(mesh, torch.zeros(2, 3),
                                        TS.P("data", None), (4, 3)))
        split = TS.to_dtensor(mesh, torch.zeros(2, 4), TS.P("data", None),
                              (4, 4))
        whole = TS.to_dtensor(mesh, torch.zeros(2, 4), TS.P(None, None),
                              (2, 4))
        out["state_rows"] = {
            k: refused(lambda: layers._state_rows(s, 2, d, "rwkv"),
                       ValueError)
            for k, (s, d) in {"same": (split, line),
                              "batch whole": (split, None),
                              "state whole": (whole, line)}.items()}
    finally:
        layers.set_attention_mesh(None)
    return out


def fsdp_rank(mesh, jobs, moe_job=None, refusals=None) -> dict:
    """A data axis over more than one rank (FSDP), for each job of
    ``jobs`` (name → {"cfg", "params" held whole, "batches" (whole), "dec"
    teacher-forced tokens or embeddings [B, n(, d)], "pins" (a moe
    config's routing, or None), "serve", "grads", "steps": what to run,
    "restart": None, or the (params, optimizer state) held whole to start
    the second step from}): serving under both layouts
    (:func:`_fsdp_serve`), the loss and gradient shards with
    ``seq_parallel`` on and off (the train step's, and for a moe config
    the aux terms' and the cross-entropy's alone, :func:`_ep_grads` on the
    batch split by ``distribute_batch``), two ``make_train_step`` steps
    (:func:`_train_steps`; given ``restart``, one from the start and one
    from it, and the two carried on, ``"carried"``); the batch's and the
    cache's local shapes; ``global_norm`` of the params tree by
    ``param_shardings`` against the whole tree's.  Given ``moe_job``,
    :func:`_fsdp_moe_apply`; given ``refusals`` (a dense cfg),
    :func:`_fsdp_refusals`.  ``DTensor.redistribute`` raises in this rank
    throughout: no path may reach it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.spmd_pipeline import batch_line
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.models import layers, moe
    from repro_torch.optim.adamw import global_norm

    def no_redistribute(self, *a, **k):
        raise AssertionError("DTensor.redistribute reached")

    saved = DTensor.redistribute
    DTensor.redistribute = no_redistribute
    pin = PinRouting()
    moe.ROUTING_HOOK = pin
    out: dict = {}
    try:
        for name, job in jobs.items():
            cfg, params = job["cfg"], job["params"]
            pin.choices = job.get("pins")
            first = TS.distribute_batch(mesh, job["batches"][0])
            r = out[name] = {"batch_local": {
                k: tuple(v.to_local().shape) for k, v in first.items()}}
            split = batch_line(first["labels"]) is not None
            pin.part = _batch_part(mesh) if split else None
            if job.get("serve"):
                r["serve"] = {lay: _fsdp_serve(mesh, cfg, params, job, lay,
                                               pin)
                              for lay in ("serving", "fsdp")}
            chunk = job["kw"]["loss_chunk"]
            if job.get("grads"):
                r["grads"] = {}
                for sp in (True, False):
                    pin.phase = "p0"
                    r["grads"][sp] = {
                        part: _ep_grads(mesh, cfg, params, first, sp,
                                        weights, chunk)
                        for part, weights in job["grads"].items()}
            if job.get("steps"):
                batches = [TS.distribute_batch(mesh, b)
                           for b in job["batches"]]
                r["steps"], r["carried"] = {}, {}
                for sp in (True, False):
                    carried = _train_steps(mesh, cfg, params, batches,
                                           job["kw"], sp, pin=pin)
                    if job.get("restart") is None:
                        r["steps"][sp] = carried
                        continue
                    mid, opt = job["restart"]
                    r["carried"][sp] = carried
                    r["steps"][sp] = [
                        _train_steps(mesh, cfg, params, batches[:1],
                                     job["kw"], sp, pin=pin),
                        _train_steps(mesh, cfg, mid, batches[1:], job["kw"],
                                     sp, opt, pin=pin, first=1)]
            p = TS.distribute_params(mesh, params,
                                     TS.param_shardings(mesh, params))
            r["norm"] = (float(global_norm(p)), float(global_norm(params)),
                         len(leaves(p)))
        if moe_job is not None:
            pin.choices = moe_job["pins"]
            pin.part = _batch_part(mesh)
            out["moe_apply"] = _fsdp_moe_apply(mesh, moe_job, pin)
        if refusals is not None:
            out["refused"] = _fsdp_refusals(mesh, refusals)
    finally:
        DTensor.redistribute = saved
        moe.ROUTING_HOOK = None
        layers.set_attention_mesh(None)
    return out


def _vlm_layouts(mesh, cfg, params, ids, img) -> dict:
    """The vlm family's caches and image rows laid out against the batch
    on a (data, model) mesh, ``LM.prefill`` of ``ids`` [B, S] (split over
    data by ``distribute_batch``) and one decode step each: "" where it
    ran, else the ValueError's message.  "jax": the ``cache_shardings``
    layout; "self split by batch": the self cache's B split over data;
    "self of another batch": a self cache of 2B rows; "image whole": the
    image K/V whole over B; "image embeddings whole": the image rows
    whole beside the prompt's split rows.  Also (``"others"``) the train
    step at ``scan_chunks`` 2 against 0 (:func:`_scan_steps`; the vlm
    family ignores it) and :func:`_pod_prefill` (``"pod"``: a (pod 2,
    model 2) mesh)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    B, S = ids.shape
    p = TS.distribute_params(mesh, params)
    split = TS.distribute_batch(mesh, {"ids": ids, "img_embeds": img})
    model, out = LM(cfg), {}

    def relaid(cache, name, spec_of):
        """``cache`` with leaf group ``name`` zeros laid out by
        ``spec_of(spec, shape)`` (a spec and a global shape) instead of
        ``cache_shardings``'s ``spec``."""
        whole = TST.abstract_cache(cfg, B, S + 1)
        specs = TS.cache_shardings(mesh, cfg, whole)

        def leaf(w, sh):
            spec, shape = spec_of(sh.spec, tuple(w.shape))
            return TS.to_dtensor(mesh, torch.zeros(
                TS.local_shape(mesh, spec, shape), dtype=w.dtype), spec,
                shape)

        return {**cache, name: tree_map(leaf, whole[name], specs[name])}

    def run(cache, image) -> str:
        try:
            model.prefill(p, split["ids"], cache, img_embeds=image)
            _, dec = TST.make_decode_step(cfg, mesh)
            dec(p, cache, {"ids": TS.distribute_batch(
                mesh, {"ids": ids[:, :1]})["ids"], "pos": S})
        except ValueError as e:
            return str(e)
        return ""

    try:
        layers.set_attention_mesh(mesh)

        def fresh():
            return TST.init_cache_sharded(cfg, mesh, B, S + 1)

        out["jax"] = run(fresh(), split["img_embeds"])
        out["self split by batch"] = run(relaid(
            fresh(), "self", lambda sp, sh: (TS.P(None, None, "data", None,
                                                  None, "model"), sh)),
            split["img_embeds"])
        out["self of another batch"] = run(relaid(
            fresh(), "self", lambda sp, sh: (sp, (*sh[:2], 2 * B, *sh[3:]))),
            split["img_embeds"])
        out["image whole"] = run(relaid(
            fresh(), "cross", lambda sp, sh: (TS.P(None, None, None, None,
                                                   "model"), sh)),
            split["img_embeds"])
        out["image embeddings whole"] = run(fresh(), img)
        out["others"] = {
            "scan_chunks": _scan_steps(mesh, cfg, params, {
                "ids": ids, "labels": ids.roll(-1, 1),
                "mask": torch.ones(ids.shape), "img_embeds": img}),
            "pod": _pod_prefill(mesh, cfg, params, {"ids": ids,
                                              "img_embeds": img})}
    finally:
        layers.set_attention_mesh(None)
    return out


def _held_probe(mesh, cfg, B, S) -> dict:
    """``_unstack`` of a vlm self cache laid out by ``cache_shardings`` on
    a (data, model) or (pod, data, model) mesh (its ``per`` split over the
    batch axes, the owner a rank's pod-major position): per layer, in the
    order g * per + j, the record's type, owner and local index; whether the owner's view is its local
    stack's at [g, j % (per / data)] (no copy) and a write to it lands in
    the stack; whether the other ranks hold no view."""
    from repro_torch.core.spmd_pipeline import HeldBy
    from repro_torch.launch import steps as TST
    from repro_torch.models.transformer import _unstack

    stack = TST.init_cache_sharded(cfg, mesh, B, S)["self"]
    layers = _unstack(stack, 2)
    G, per = stack["k"].shape[:2]
    me = _batch_part(mesh)[0]
    local = stack["k"].to_local()
    out = []
    for i, lc in enumerate(layers):
        g, j = divmod(i, per)
        rec = lc["k"]
        if not isinstance(rec, HeldBy):
            out.append(("view", None, None, True))
            continue
        ok = (rec.layer is None) == (rec.owner != me)
        if rec.layer is not None:
            jl = j % local.shape[1]
            view = rec.layer.to_local()
            ok = ok and view.data_ptr() == local[g, jl].data_ptr()
            view[0, 0, 0, 0] = float(i + 1)
            ok = ok and float(local[g, jl, 0, 0, 0, 0]) == float(i + 1)
        out.append(("held", rec.owner, rec.index, ok))
    return out


def fsdp_vlm_rank(mesh, jobs, layouts=None) -> dict:
    """The vlm family under a data axis: :func:`fsdp_rank` for ``jobs``
    (each with ``"img"``, the served image embeddings), each serving run's
    self-cache exchanges counted (the calls of ``layers.held_rows``, by
    job); given ``layouts`` (cfg, params, ids [B, S], image embeddings [B,
    M, d]), :func:`_vlm_layouts`, and :func:`_held_probe` of that config
    at that batch."""
    from repro_torch.models import layers

    real, calls = layers.held_rows, {}

    def counted(x, split):
        calls[job] = calls.get(job, 0) + 1
        return real(x, split)

    out = {}
    layers.held_rows = counted
    try:
        for job in jobs:
            out.update(fsdp_rank(mesh, {job: jobs[job]}))
            out[job]["held_rows_calls"] = calls.get(job, 0)
    finally:
        layers.held_rows = real
    if layouts is not None:
        cfg, params, ids, img = layouts
        out["layouts"] = _vlm_layouts(mesh, cfg, params, ids, img)
        out["held"] = _held_probe(mesh, cfg, *ids.shape)
    return out


def ckpt_rank(mesh, cfg, params, batch, kw, root, jax_root=None) -> dict:
    """The checkpoint store on a sharded train state: one
    ``make_train_step`` step from ``params`` (held whole) on ``batch``
    (split by ``distribute_batch``), saved under ``root`` by
    ``CheckpointStore.save`` (every rank), restored by ``shardings=``
    (``param_shardings``, ``opt_shardings``) and without; then
    ``save_async`` of step 2 and ``wait``.  Returns this rank's shards of
    the saved and the restored state (``_shards``), whether each restored
    leaf is a DTensor exactly where the saved one is, with its placements,
    the whole leaves of the plain restore (path -> tensor), each rank's
    ``latest_step`` after either save, and a planted fault: the restored
    shards with the first split leaf read one row (along its split dim)
    off its bounds on rank 1.  Given ``jax_root`` (a checkpoint the JAX
    package's store wrote from a state on a mesh of the same shape), its
    restore by ``shardings=``'s shards."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.spmd_pipeline import is_dtensor, local_bounds
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers

    try:
        _, step = TST.make_train_step(cfg, mesh, **kw)
        state = TST.init_train_state_sharded(cfg, mesh, params)
        state, _ = step(state, TS.distribute_batch(mesh, batch))
        sh = {"params": TS.param_shardings(mesh, params),
              "opt": TS.opt_shardings(mesh, state["opt"], params)}
        store = CheckpointStore(root, keep=2)
        store.save(1, state, {"next_step": 1})
        latest = [store.latest_step()]
        got, extra = store.restore(1, like=state, shardings=sh)
        whole, _ = store.restore(None, like=state)
        laid_out = all(
            is_dtensor(a) == is_dtensor(b)
            and (not is_dtensor(a) or a.placements == b.placements)
            for a, b in zip(leaves(got), leaves(state)))
        restored = _shards(got)
        planted = dict(restored)
        path, dim = next(
            (p, d) for p, (_, at, shape) in restored.items()
            for d, n in enumerate(shape) if at[d].stop - at[d].start < n)
        if mesh.rank == 1:
            full = {}
            TS.map_with_path(lambda p, a: full.__setitem__(TS.path_str(p), a),
                             whole)
            _, at, shape = restored[path]
            planted[path] = (full[path].roll(-1, dim)[at].clone(), at, shape)
        store.save_async(2, state, {"next_step": 2})
        store.wait()
        latest.append(store.latest_step())
        out = {"saved": _shards(state), "restored": restored,
               "planted": planted, "planted_path": path,
               "laid_out": laid_out, "extra": extra, "latest": latest,
               "whole": {p: t for p, (t, _, _) in _shards(whole).items()},
               "whole_plain": not any(is_dtensor(a) for a in leaves(whole)),
               "step_plain": not is_dtensor(got["opt"].step),
               "bounds_equal": all(
                   local_bounds(a) == local_bounds(b)
                   for a, b in zip(leaves(got), leaves(state)))}
        if jax_root is not None:
            theirs, _ = CheckpointStore(jax_root).restore(None, like=state,
                                                          shardings=sh)
            out["jax"] = _shards(theirs)
        return out
    finally:
        layers.set_attention_mesh(None)


def _planted_owner(mesh, job) -> dict:
    """The vlm ``job`` served under the serving layout (:func:`_fsdp_serve`)
    with a planted fault: every self-cache layer's owner one rank on along
    its line (``owner + 1``), that rank holding the view at the layer's
    local index, so each layer's rows are written and read on the wrong
    rank's stack; its cache's shards."""
    from dataclasses import replace

    from repro_torch.core.spmd_pipeline import HeldBy
    from repro_torch.models import transformer

    real = transformer.unbind_layers

    def planted(x, dims=1):
        recs = real(x, dims)
        if not recs or not isinstance(recs[0], HeldBy):
            return recs
        mine = {r.index: r.layer for r in recs if r.layer is not None}
        out = []
        for r in recs:
            owner = (r.owner + 1) % r.size
            out.append(replace(r, owner=owner, layer=mine.get(r.index)
                               if owner == r.position else None))
        return out

    transformer.unbind_layers = planted
    try:
        return _fsdp_serve(mesh, job["cfg"], job["params"], job, "serving",
                           PinRouting())["cache"]
    finally:
        transformer.unbind_layers = real


def pod_rank(mesh, jobs, moe_job=None, plant=None) -> dict:
    """``pod`` as a second batch axis (a (pod, data, model) mesh): the
    jobs of :func:`fsdp_rank` (a vlm config's through
    :func:`fsdp_vlm_rank`, its self-cache exchanges counted, and
    :func:`_held_probe` of its config at its batch), ``moe_job`` as there,
    and given ``plant`` (a vlm job's name), :func:`_planted_owner` of that
    job."""
    vlm = {n: j for n, j in jobs.items() if j["cfg"].cross_attn_every}
    out = fsdp_rank(mesh, {n: j for n, j in jobs.items() if n not in vlm},
                    moe_job)
    out.update(fsdp_vlm_rank(mesh, vlm))
    for name, job in vlm.items():
        out[name]["held"] = _held_probe(mesh, job["cfg"],
                                        *job["batches"][0]["ids"].shape)
    if plant is not None:
        out["planted"] = _planted_owner(mesh, jobs[plant])
    return out


def pod_card_rank(mesh, cfg, params, batch, kw) -> dict:
    """A (pod, data, model) mesh on the rank's device: the params (held
    whole) by ``param_shardings``, ``batch`` split over ``("pod",
    "data")`` by ``distribute_batch``; the prefill step's logits read
    whole, one ``make_train_step`` step's metrics, and the ranks of the
    batch's line (``batch_line``: the (pod, data) group)."""
    import torch.distributed as dist

    from repro_torch.core.spmd_pipeline import batch_line
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers

    try:
        whole = tree_map(lambda a: a.to(mesh.device), params)
        split = TS.distribute_batch(mesh, {k: v.to(mesh.device)
                                           for k, v in batch.items()})
        p = TS.distribute_params(mesh, whole, TS.param_shardings(mesh, whole))
        logits = TS.collect_batch(TST.make_prefill_step(cfg, mesh)[1](
            p, {"ids": split["ids"]}))
        _, step = TST.make_train_step(cfg, mesh, **kw)
        _, met = step(TST.init_train_state_sharded(cfg, mesh, whole), split)
        return {"logits": logits.cpu(),
                "metrics": {k: float(v) for k, v in met.items()},
                "line": dist.get_process_group_ranks(
                    batch_line(split["ids"])[0]),
                "rows": tuple(split["ids"].to_local().shape)}
    finally:
        layers.set_attention_mesh(None)


class _DataGathers:
    """Counts ``spmd_pipeline._Gather``'s forwards and backwards over the
    ranks of ``layout``'s ``data`` line (the gathers of a weight's ``data``
    dim and the sums of their gradients) while it is entered."""

    def __init__(self, layout):
        import torch.distributed as dist

        self.line = (dist.get_process_group_ranks(
            layout.device_mesh.get_group("data"))
            if layout.shape["data"] > 1 else None)
        self.counts = {"forward": 0, "backward": 0}

    def _mine(self, group) -> bool:
        import torch.distributed as dist

        return (self.line is not None
                and dist.get_process_group_ranks(group) == self.line)

    def __enter__(self):
        from repro_torch.core import spmd_pipeline as SP

        self.counts = {"forward": 0, "backward": 0}
        fwd, bwd = self.saved = (SP._Gather.forward, SP._Gather.backward)

        def forward(ctx, t, dim, group, transport, sum_grad):
            self.counts["forward"] += self._mine(group)
            return fwd(ctx, t, dim, group, transport, sum_grad)

        def backward(ctx, g):
            self.counts["backward"] += self._mine(ctx.group)
            return bwd(ctx, g)

        SP._Gather.forward = staticmethod(forward)
        SP._Gather.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import spmd_pipeline as SP

        SP._Gather.forward = staticmethod(self.saved[0])
        SP._Gather.backward = staticmethod(self.saved[1])


def _equal_runs(a, b) -> bool:
    """Two :func:`_ep_grads` results hold the same loss and the same
    gradient shards, bit for bit."""
    return a[0] == b[0] and all(
        torch.equal(x[0], y[0]) and x[1:] == y[1:]
        for x, y in zip(a[1].values(), b[1].values())) and (
        a[1].keys() == b[1].keys())


def _stored(layout, cfg, params, batch, kw, root) -> dict:
    """One ``make_train_step`` step of ``cfg`` (its ``kw``) from
    ``params`` (held whole) on ``batch`` (split), the trained state saved
    under ``root`` by ``CheckpointStore`` and restored by ``shardings=``:
    the trained state's shards, and whether the restored state holds the
    same placements and local tensors, bit for bit."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.spmd_pipeline import is_dtensor, local_tensor
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST

    _, step = TST.make_train_step(cfg, layout, **kw)
    state, _ = step(TST.init_train_state_sharded(cfg, layout, params), batch)
    store = CheckpointStore(root, keep=1)
    store.save(1, state, {"next_step": 1})
    got, extra = store.restore(1, like=state, shardings={
        "params": TS.param_shardings(layout, params),
        "opt": TS.opt_shardings(layout, state["opt"], params)})
    return {"trained": _shards(state), "equal": extra == {"next_step": 1}
            and all(is_dtensor(a) == is_dtensor(b)
                    and (not is_dtensor(a) or a.placements == b.placements)
                    and torch.equal(local_tensor(a), local_tensor(b))
                    for a, b in zip(leaves(got), leaves(state)))}


def remat_rank(mesh, layouts, jobs, vlm=None, root=None) -> dict:
    """Nested remat (``scan_chunks``) under sharded weights, and a
    ``stage`` axis, on the layouts ``layouts`` (key → (shape, axes)) built
    over this spawn's ranks (:func:`_same_ranks`), for each job of
    ``jobs`` (name → {"cfg", "params" held whole, "batches", "dec",
    "layout": a key of ``layouts``, "pins" (a moe config's routing, or
    None), "kw" (with its ``scan_chunks``), "grads": the seq_parallel
    settings to run, "steps", "serve", "ckpt"}): the loss and gradient
    shards of ``loss_and_grads`` at ``scan_chunks`` 2, whether the runs at
    0 and 3 (which 4 layers ignore) give the same bits, and the ``data``
    gathers of each (:class:`_DataGathers`); two ``make_train_step`` steps
    (:func:`_train_steps`); serving under both layouts
    (:func:`_fsdp_serve`); and a trained state's round trip through the
    checkpoint store under ``root`` (:func:`_stored`).  ``vlm`` (cfg,
    params, batch held whole): :func:`_scan_steps` on each layout with a
    data axis of 2.
    ``DTensor.redistribute`` raises in this rank throughout."""
    import os

    from torch.distributed.tensor import DTensor

    from repro_torch.core.spmd_pipeline import batch_line
    from repro_torch.launch import sharding as TS
    from repro_torch.models import layers, moe

    def no_redistribute(self, *a, **k):
        raise AssertionError("DTensor.redistribute reached")

    built = {k: _same_ranks(mesh, *v) for k, v in layouts.items()}
    saved = DTensor.redistribute
    DTensor.redistribute = no_redistribute
    pin = PinRouting()
    moe.ROUTING_HOOK = pin
    out: dict = {"coord": {k: tuple(lay.axis_index(a) for a in lay.axis_names)
                           for k, lay in built.items()}}
    try:
        for name, job in jobs.items():
            lay, cfg, params = built[job["layout"]], job["cfg"], job["params"]
            kw = job["kw"]
            pin.choices = job.get("pins")
            first = TS.distribute_batch(lay, job["batches"][0])
            split = batch_line(first["labels"]) is not None
            pin.part = _batch_part(lay) if split else None
            r = out[name] = {}
            count = _DataGathers(lay)
            if job.get("grads"):
                r["grads"] = {}
                for sp in job["grads"]:
                    runs, gathers = {}, {}
                    for c in (2, 0, 3):
                        pin.phase = "p0"
                        with count:
                            runs[c] = _ep_grads(lay, cfg, params, first, sp,
                                                None, kw["loss_chunk"], c)
                        gathers[c] = dict(count.counts)
                    r["grads"][sp] = {
                        "run": runs[2], "gathers": gathers,
                        "equal": {c: _equal_runs(runs[c], runs[2])
                                  for c in (0, 3)}}
            if job.get("steps"):
                batches = [TS.distribute_batch(lay, b)
                           for b in job["batches"]]
                r["steps"] = _train_steps(lay, cfg, params, batches, kw, True,
                                          pin=pin)
            if job.get("serve"):
                r["serve"] = {s: _fsdp_serve(lay, cfg, params, job, s, pin)
                              for s in ("serving", "fsdp")}
            if job.get("ckpt"):
                pin.phase = "p0"
                r["ckpt"] = _stored(lay, cfg, params, first, kw,
                                    os.path.join(root, name))
            layers.set_attention_mesh(None)
        if vlm is not None:
            cfg, params, batch = vlm
            pin.choices, pin.part = None, None
            out["vlm"] = {}
            for key, lay in built.items():
                if lay.shape.get("data", 1) > 1:
                    out["vlm"][key] = _scan_steps(lay, cfg, params, batch)
    finally:
        DTensor.redistribute = saved
        moe.ROUTING_HOOK = None
        layers.set_attention_mesh(None)
    return out
