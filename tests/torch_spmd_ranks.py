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
