"""End-to-end training on the PyTorch port: a ~100M-parameter LM, a few
hundred steps (the counterpart of ``examples/train_100m.py``).

The whole substrate stack: the synthetic data stream, AdamW, per-layer
remat, the checkpoint store and the fault-tolerant restart driver.  The
loss must fall on the structured synthetic stream.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 20

Without ``--device cpu`` it runs on the card (every attention through K7
forward and K8/K9 backward), and refuses to run without one.
"""
import argparse
from dataclasses import replace

import numpy as np

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.launch.train import build
from repro_torch.runtime import FaultTolerantDriver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt/torch_train100m")
    args = ap.parse_args(argv)

    # ~100M params: gemma3 family, scaled down
    cfg = replace(get_config("gemma3-12b"),
                  n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
                  head_dim=64, d_ff=2560, vocab=32768, window=32,
                  global_every=6, dtype="float32")
    print(f"model: {cfg.n_params / 1e6:.1f}M params")

    state, step, data = build(cfg, args.steps, lr=3e-3,
                              seq_len=args.seq_len, global_batch=args.batch,
                              device=args.device)
    store = CheckpointStore(args.ckpt_dir, keep=2)
    driver = FaultTolerantDriver(step, store, data, ckpt_every=100)
    state, res = driver.run(state, args.steps)
    n = min(10, len(res.losses) // 2)
    first, last = np.mean(res.losses[:n]), np.mean(res.losses[-n:])
    print(f"steps={res.steps_done} loss {first:.3f} -> {last:.3f}")
    assert last < first, "loss did not decrease!"
    print("OK: loss decreased")


if __name__ == "__main__":
    main()
