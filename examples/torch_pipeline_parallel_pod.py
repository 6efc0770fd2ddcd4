"""Courier across ranks: balanced pipeline parallelism on torch.distributed.

The port's counterpart of ``examples/pipeline_parallel_pod.py``, step for
step.  The Pipeline Generator decides stage boundaries from per-layer
costs; here they place a 12-layer stack onto a 4-stage mesh axis, and a
microbatch token pipeline (send / receive hand-offs) executes them — TBB
tokens become microbatches.  The layers are deliberately heterogeneous in
cost, so the Courier partition differs from an equal-count split, and the
example prints the predicted bottleneck of each.  Then a stage group is
lost and the ElasticPlanner re-plans onto 3 stages.

Each stage is a process of its own (``run_on_local_mesh``).  On the card
(the default) the four ranks share it and hand off through pinned host
memory over gloo; ``--device cpu`` runs them on the host.

    PYTHONPATH=src python examples/torch_pipeline_parallel_pod.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (linear_ir, partition_optimal, partition_paper,
                              pipeline_microbatches, resolve_device)
from repro_torch.launch.mesh import run_on_local_mesh
from repro_torch.runtime import ElasticPlanner


def block(p, x):
    return x + torch.tanh(x @ p["win"]) @ p["wout"]


def stage_rank(mesh, params, boundaries, xs):
    """One rank: its stage of the token pipeline; every rank returns the
    outputs."""
    dev = mesh.device
    params = {k: v.to(dev) for k, v in params.items()}
    with torch.no_grad():
        return pipeline_microbatches(mesh, block, params, boundaries,
                                     xs.to(dev)).cpu()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the ranks on the host (default: card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # A 12-layer stack whose second half is 4x wider (cost-heterogeneous,
    # like a vlm's cross-attn tail): equal-count splitting is unbalanced
    # here, the Courier partition is not.
    L, d = 12, 32
    widths = [4 * d if i >= 6 else d for i in range(L)]
    g = torch.Generator().manual_seed(0)
    Win = torch.stack([torch.nn.functional.pad(
        torch.randn((d, w), generator=g) * 0.2, (0, 4 * d - w))
        for w in widths])
    Wout = torch.stack([torch.nn.functional.pad(
        torch.randn((w, d), generator=g) * 0.2, (0, 0, 0, 4 * d - w))
        for w in widths])
    params = {"win": Win, "wout": Wout}

    # Courier: per-layer cost model → balanced boundaries
    cost = [2.0 * d * w * 2 for w in widths]          # matmul flops per layer
    ir = linear_ir("layers", [f"L{i}" for i in range(L)], cost)
    paper_plan = partition_paper(ir, n_threads=3)
    opt_plan = partition_optimal(ir, max_stages=4)
    naive_bottleneck = max(sum(cost[i:i + 3]) for i in range(0, L, 3))
    print("naive equal-count bottleneck :", naive_bottleneck)
    print("paper-policy bottleneck      :", paper_plan.bottleneck_ms)
    print("optimal-DP bottleneck        :", opt_plan.bottleneck_ms)

    boundaries, i = [], 0
    for s in opt_plan.stages:
        boundaries.append(i)
        i += len(s.node_names)
    while len(boundaries) < 4:                        # pad to mesh stages
        boundaries.append(L - 1)
    print("stage boundaries (layer idx) :", boundaries)

    # run the token pipeline and check semantics vs sequential
    M, mb = 6, 4
    xs = torch.randn((M, mb, d), generator=torch.Generator().manual_seed(1))
    out = run_on_local_mesh((4,), ("stage",), stage_rank, params, boundaries,
                            xs, device=device, timeout=300)[-1]

    h = xs
    for i in range(L):
        h = block({"win": Win[i], "wout": Wout[i]}, h)
    torch.testing.assert_close(out, h, rtol=2e-4, atol=2e-4)
    print("pipeline output == sequential stack: OK")

    # elasticity: a stage group is lost -> re-plan for 3 stages (Courier
    # re-balance), not job abort
    b3 = ElasticPlanner(ir, device=device).boundaries(3)
    out3 = run_on_local_mesh((3,), ("stage",), stage_rank, params, b3, xs,
                             device=device, timeout=300)[-1]
    torch.testing.assert_close(out3, h, rtol=2e-4, atol=2e-4)
    print(f"elastic re-plan to 3 stages {b3}: OK")


if __name__ == "__main__":
    main()
