"""Training launcher — the port of the JAX package's ``launch/train.py``.

Runs a training loop for the LM (dense or moe) with the whole substrate
stack: the synthetic data stream, AdamW, per-layer remat, checkpointing,
fault-tolerant restart and straggler monitoring.  It runs on the card
unless given ``--device cpu`` (and refuses to run without a card
otherwise); every self-attention runs K7 forward and K8/K9 backward there.

    python -m repro_torch.launch.train --device cpu --reduced --steps 30
    python -m repro_torch.launch.train --no-reduced --layers 6 --steps 20 \\
        --seq-len 4096 --batch 2 --ckpt-every 1000

As in the JAX launcher, the loss check compares the mean of the first 5
steps with the last 5 (so it needs more than 5 steps), and the driver saves
at the last step whatever ``--ckpt-every`` says: at full gemma3-12b widths
and 6 layers that is one ~23.5 GB checkpoint under ``--ckpt-dir``.

Unlike the JAX package's CLI, ``--reduced`` is a ``BooleanOptionalAction``
(default off, as there), and ``--layers N`` cuts the depth only.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import CheckpointStore
from ..core.placement import resolve_device
from ..data import SyntheticLMData
from ..models import LM
from ..optim import adamw_init
from ..runtime import FaultTolerantDriver, StragglerMonitor
from .steps import make_train_step


def build(cfg, steps: int, lr: float, seq_len: int, global_batch: int, *,
          device=None):
    """→ (state, ``step(state, Batch)``, data) for ``cfg`` on ``device``
    (the card unless ``device="cpu"``): weights from seed 0, the JAX
    launcher's warmup (steps // 20, at least 5) and loss chunk."""
    dev = resolve_device(device)
    model = LM(cfg)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=seq_len,
                           global_batch=global_batch, seed=0)
    _, step_fn = make_train_step(cfg, lr=lr, warmup=max(steps // 20, 5),
                                 total_steps=steps,
                                 loss_chunk=min(512, seq_len))

    def step(state, batch):
        b = {"ids": torch.as_tensor(batch.ids, device=dev).long(),
             "labels": torch.as_tensor(batch.labels, device=dev).long(),
             "mask": torch.as_tensor(batch.mask, device=dev)}
        if cfg.embeds_in:
            # stub modality frontend: embed tokens via the tied table
            b["embeds"] = state["params"]["embed"]["table"][b.pop("ids")]
        return step_fn(state, b)

    params = model.init(torch.Generator(dev).manual_seed(0))
    state = {"params": params, "opt": adamw_init(params)}
    return state, step, data


def main(argv: list[str] | None = None):
    from ..configs import ARCH_IDS
    from .serve import lm_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-12b")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="a tiny same-family config (off by default)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = lm_config(args.arch, reduced=args.reduced, layers=args.layers)
    print(f"[train] arch={cfg.arch_id} N={cfg.n_params/1e6:.1f}M params "
          f"(reduced={args.reduced}, layers={cfg.n_layers}) on {dev}")
    state, step, data = build(cfg, args.steps, args.lr, args.seq_len,
                              args.batch, device=dev)
    store = CheckpointStore(f"{args.ckpt_dir}/{cfg.arch_id}", keep=2)
    driver = FaultTolerantDriver(step, store, data,
                                 ckpt_every=args.ckpt_every,
                                 straggler=StragglerMonitor())
    t0 = time.time()
    state, res = driver.run(state, args.steps)
    dt = time.time() - t0
    n_tok = args.steps * args.batch * args.seq_len
    first = np.mean(res.losses[:5]) if len(res.losses) >= 5 else res.losses[0]
    last = np.mean(res.losses[-5:])
    print(f"[train] {res.steps_done} steps in {dt:.1f}s "
          f"({n_tok / dt:.0f} tok/s), loss {first:.3f} -> {last:.3f}, "
          f"restarts={res.restarts}, stragglers={len(driver.straggler.flagged)}")
    assert last < first, "loss did not decrease"
    return res


if __name__ == "__main__":
    main()
