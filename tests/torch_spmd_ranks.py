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


def tp_serve_rank(mesh, cfg, params, ids, steps):
    """Tensor-parallel serving of ``cfg`` on the mesh's model axis from a
    params tree held whole: each leaf's local and global shape and its
    spec, the prefill step's logits, the cache filled by ``LM.prefill``,
    the decode step's logits for each of ``steps`` [B, n] tokens
    (teacher-forced), this rank's cache shards with their bounds, and its
    K7 launches by route."""
    from repro_torch.core.spmd_pipeline import is_dtensor, local_bounds
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers

    fa.reset_launches()
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
        logits = pre(sharded, {"ids": ids})
        S, n = ids.shape[1], steps.shape[1]
        cache = TST.init_cache_sharded(cfg, mesh, ids.shape[0], S + n)
        model.prefill(sharded, ids, cache)
        _, dec = TST.make_decode_step(cfg, mesh)
        dec_logits = []
        for j in range(n):
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
                "k7_routes": dict(fa.ROUTE_LAUNCHES["flash_attention"])}
    finally:
        layers.set_attention_mesh(None)


def tp_init_rank(mesh, cfg, moe_cfg, seed):
    """``distribute_params`` of a whole draw: each leaf's local tensor is
    the whole leaf at its ``local_bounds``, contiguous, and nothing else;
    ``init_cache_sharded``'s local shapes; the refusals: the serve step's
    of a data axis over one rank and of the moe family, and K7's of a
    DTensor (its plain version must not take one)."""
    from repro_torch.core.spmd_pipeline import local_bounds
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    def gen():
        return torch.Generator(mesh.device).manual_seed(seed)

    whole = LM(cfg).init(gen())
    drawn = TS.distribute_params(mesh, whole)
    same = all(torch.equal(d.to_local(), w[local_bounds(d)])
               and d.to_local().is_contiguous() and d.shape == w.shape
               for d, w in zip(leaves(drawn), leaves(whole)))
    cache = TST.init_cache_sharded(cfg, mesh, 4, 16)
    shapes = {}
    TS.map_with_path(lambda p, a: shapes.__setitem__(
        TS.path_str(p), tuple(a.to_local().shape)), cache)
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
                          ("moe_refused", moe_cfg, TS.distribute_params(
                              mesh, LM(moe_cfg).init(gen())))):
            try:
                TST.make_prefill_step(c, mesh)[1](p, {"ids": ids})
                refused[key] = ""
            except NotImplementedError as e:
                refused[key] = str(e)
    finally:
        layers.set_attention_mesh(None)
    return {"shards_of_whole_draw": same, "cache_shapes": shapes,
            "cache_zero": all(not a.to_local().any() for a in leaves(cache)),
            **refused}
