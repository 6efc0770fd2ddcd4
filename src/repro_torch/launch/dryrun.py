"""Multi-pod dry-run — the port of the JAX package's ``launch/dryrun.py``,
what maps of it.

For every (architecture x input shape) cell, on the single-pod 16 x 16
mesh and the 2 x 16 x 16 multi-pod mesh, :func:`run_cell` reports per
device the bytes of the parameters, the optimizer state, the cache and the
batch under their sharding specs (the part of the JAX cell's
``memory_analysis`` that counts the step's arguments), and the FLOPs of
the port's cost model (:func:`~repro_torch.core.costmodel.lm_layer_cost`;
forward and backward count 3x the forward for a train cell).  It runs on
the meta device: the trees are meta tensors and nothing is allocated.

What does not map: the JAX cell lowers and compiles the step with XLA and
reads the compiled HLO's ``memory_analysis`` (temporaries, outputs,
generated code), ``cost_analysis`` and the collectives' bytes
(``collective_bytes`` over the post-SPMD HLO).  PyTorch compiles no
whole-step program to read them from, so the record says so under
``not_mapped`` and holds no such figure.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod|--both]
"""
from __future__ import annotations

import argparse
import json
import math
import os
from dataclasses import replace

from ..configs import ARCH_IDS, SHAPES, get_config, supports_shape
from ..core.costmodel import lm_layer_cost, matmul_cost
from ..core.tree import leaves
from .mesh import make_production_mesh
from .sharding import local_shape
from .steps import batch_structs, serve_structs, train_state_structs

NOT_MAPPED = {
    "memory_analysis": "XLA's compiled temporaries, outputs and code; "
                       "PyTorch compiles no whole-step program",
    "cost_analysis": "XLA's compiled FLOPs and bytes; the cost model's "
                     "FLOPs stand in",
    "collectives": "the post-SPMD HLO's collective bytes; no PyTorch "
                   "counterpart",
}


def default_scan_chunks(n_layers: int) -> int:
    """Largest divisor of L not exceeding ~sqrt(L) (nested-remat chunk)."""
    best = 1
    for c in range(1, int(math.isqrt(n_layers)) + 2):
        if n_layers % c == 0:
            best = c
    return best


def probe_layer_counts(cfg) -> tuple[int, int]:
    """The two depths the JAX dry-run compiles to extrapolate in L: one and
    two periods of the layer pattern."""
    if cfg.cross_attn_every:
        return cfg.cross_attn_every, 2 * cfg.cross_attn_every
    if cfg.global_every:
        return cfg.global_every, 2 * cfg.global_every
    return 1, 2


def probe_extrapolate(p1: dict, p2: dict, n_layers: int) -> dict:
    """total(L) = C(k1) + (C(k2) - C(k1)) / (k2 - k1) * (L - k1), for the
    flops, the bytes and each collective."""
    k1, k2 = p1["k"], p2["k"]
    out = {"flops": 0.0, "bytes": 0.0, "collectives": {}}

    def lerp(a, b):
        return a + (b - a) / (k2 - k1) * (n_layers - k1)

    out["flops"] = lerp(p1["cost"].get("flops", 0.0),
                        p2["cost"].get("flops", 0.0))
    out["bytes"] = lerp(p1["cost"].get("bytes accessed", 0.0),
                        p2["cost"].get("bytes accessed", 0.0))
    keys = set(p1["collectives"]) | set(p2["collectives"])
    for key in keys:
        out["collectives"][key] = lerp(p1["collectives"].get(key, 0.0),
                                       p2["collectives"].get(key, 0.0))
    return out


def _nbytes(struct) -> int:
    """A struct's bytes on one device under its sharding."""
    sh = struct.sharding
    shape = local_shape(sh.mesh, sh.spec, struct.shape)
    return math.prod(shape) * struct.dtype.itemsize


def _tree_bytes(tree) -> int:
    return sum(_nbytes(s) for s in leaves(tree))


def _model_cost(cfg, shape) -> dict:
    """The cost model's forward FLOPs and bytes for one step (a decode
    step: one token a sequence; the lm head included)."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    total = matmul_cost(B * S, cfg.vocab_padded, cfg.d_model,
                        4 if cfg.dtype == "float32" else 2)
    for i in range(cfg.n_layers):
        total = total + lm_layer_cost(cfg, B, S, i)
    mult = 3.0 if shape.kind == "train" else 1.0
    return {"flops": mult * total.flops, "bytes accessed": total.bytes_rw}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, serving_layout: bool = False,
             probe: bool = True, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "kind": shape.kind,
                 "n_params": cfg.n_params,
                 "n_params_active": cfg.n_params_active,
                 "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    ok, why = supports_shape(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        _write(rec, out_dir)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec["chips"] = mesh.size
    per = {"batch": _tree_bytes(batch_structs(cfg, shape, mesh))}
    if shape.kind == "train":
        rec["scan_chunks"] = default_scan_chunks(cfg.n_layers)
        state, _ = train_state_structs(cfg, mesh)
        per["params"] = _tree_bytes(state["params"])
        per["opt"] = _tree_bytes(state["opt"])
    else:
        sv = serve_structs(cfg, shape, mesh, serving_layout=serving_layout)
        per["params"] = _tree_bytes(sv["params"])
        if "cache" in sv:
            per["cache"] = _tree_bytes(sv["cache"])
    per["total"] = sum(per.values())
    cost = _model_cost(cfg, shape)
    rec.update(status="ok", bytes_per_device=per, cost=cost,
               flops_per_device=cost["flops"] / mesh.size,
               not_mapped=NOT_MAPPED)
    if probe:
        k1, k2 = probe_layer_counts(cfg)
        p1, p2 = ({"k": k, "collectives": {},
                   "cost": _model_cost(replace(cfg, n_layers=k), shape)}
                  for k in (k1, k2))
        rec["probe"] = {"p1": p1, "p2": p2,
                        "extrapolated": probe_extrapolate(p1, p2,
                                                          cfg.n_layers)}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] bytes a device "
              f"{ {k: f'{v / 1e9:.3f} GB' for k, v in per.items()} }, "
              f"cost-model flops {cost['flops']:.3e} "
              f"({rec['flops_per_device']:.3e} a device)")
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: str | None) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod and multi-pod meshes")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--serving-layout", action="store_true",
                    help="TP-only weights for prefill/decode (no FSDP)")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    meshes = [False, True] if args.both else [args.multi_pod]
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    for arch, shape in cells:
        for mp in meshes:
            run_cell(arch, shape, mp, out_dir=args.out,
                     probe=not args.no_probe,
                     serving_layout=args.serving_layout)


if __name__ == "__main__":
    main()
