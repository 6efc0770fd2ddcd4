"""The moe cell (``chip_smoke.py``'s phase 8: moonshot-v1-16b-a3b served at
6 layers, 4 x 4096 prompt, 32 tokens, and trained at 2 layers) of several
checkouts in turns on one CUDA card, one fresh process a turn.

    python3 tools/moe_cell_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``chip_smoke.py`` and ``src/``),
for example a parent commit's unpacked by ``git archive`` into ``build/``;
name them in the order to run, e.g. ``build/parent . . build/parent``.  A
turn builds that tree's kernels (``phase_build``) and runs its
``phase_moe`` as ``chip_smoke.py`` does, its gates included, then profiles
one more training step of the cell (``chip_smoke.device_profile``, after
two warm-up steps); its lines are printed with ``[turn i TREE]`` in front.
Prints the card's name and power limit, lines a turn of what it measured,
and last one JSON object of the turns' figures (ms, GB).  Exits non-zero
if a turn fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

TURN = r"""
import json, os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import chip_smoke as c
c.phase_device()
c.phase_build()
_, out = c.phase_moe(0.0)
tr = out["train"]
# one more training step of the cell, profiled (after two warm-up steps)
from repro_torch.launch.serve import lm_config
from repro_torch.launch.train import build
m = c.MOE
cfg = lm_config(m["arch"], reduced=False, layers=m["train_layers"])
state, step, data = build(cfg, 3, m["lr"], m["train_seq"], m["train_batch"],
                          device="cuda")
box = {"state": state}


def train_step(i=0):
    box["state"], met = step(box["state"], data.batch(i))
    float(met["loss"])


train_step(0)
train_step(1)
prof = c.device_profile(lambda: train_step(2), ranges="moe:")
print("TURN " + json.dumps({
    "train_profile": {k: prof[k] for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "ranges", "top")},
    "prefill_ms": out["prefill_ms"],
    "prefill_device_ms": out["prefill_device_ms"],
    "decode_ms_per_token": out["decode_ms_per_token"],
    "prefill_profile": {k: out["profile"]["prefill"][k] for k in (
        "wall_ms", "device_busy_ms", "device_idle_share", "ranges")},
    "serve_peak_gb": out["serve_peak_gb"],
    "train_median_step_ms": tr["median_step_ms"],
    "train_step_ms": tr["step_ms"], "train_peak_gb": tr["peak_gb"],
    "train_losses": tr["losses"]}))
"""


def main(trees: list[str]) -> int:
    if not trees:
        print(__doc__)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}")
    turns = []
    for i, tree in enumerate(trees):
        root = os.path.abspath(tree)
        label = f"[turn {i} {tree}]"
        proc = subprocess.Popen([sys.executable, "-c", TURN], cwd=root,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        got = None
        for line in proc.stdout:
            if line.startswith("TURN "):
                got = json.loads(line[5:])
            else:
                print(f"{label} {line}", end="")
        if proc.wait() != 0 or got is None:
            print(f"{label} failed: exit {proc.returncode}")
            return 1
        print(f"{label} prefill {got['prefill_ms']:.3f} ms (card "
              f"{got['prefill_device_ms']:.3f}), decode "
              f"{got['decode_ms_per_token']:.3f} ms a token, profiled "
              f"prefill by range {got['prefill_profile']['ranges']}, train "
              f"step median {got['train_median_step_ms']:.3f} ms (steps "
              f"{got['train_step_ms']}), peak serve / train "
              f"{got['serve_peak_gb']:.3f} / {got['train_peak_gb']:.3f} GB")
        tp = got["train_profile"]
        print(f"{label} profiled train step: wall {tp['wall_ms']:.3f} ms, "
              f"card busy {tp['device_busy_ms']:.3f} ms, idle share "
              f"{tp['device_idle_share']}, by range {tp['ranges']}")
        turns.append({"tree": tree, **got})
    print(json.dumps({"card": smi.stdout.strip(), "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
