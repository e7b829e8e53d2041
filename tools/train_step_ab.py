"""Time the one-device train step of two checkouts of the port in turns.

    git archive <commit> | tar -x -C build/parent
    python3 tools/train_step_ab.py --parent build/parent [--steps 3]

Runs parent, this checkout, this checkout, parent, each in a process of
its own (both packages are named ``repro_torch``): llama3.2-1b at full
width and depth (bfloat16 compute, float32 masters drawn from a generator
seeded 2009), one 4,096-token sequence per step (``n_acc`` 1, remat, the
``masked`` loss, ``chip_smoke.py`` phase 13's step at batch 1), one
warm-up step, then ``--steps`` steps on the host clock, synchronized.
Prints each run's step times and losses as JSON, with the card's name and
power limit; the two trees' losses must be equal.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import OptConfig
cfg = get_config("llama3.2-1b")
shape = ShapeConfig("train_4k", "train", seq_len=4096, global_batch=1)
built = build_train_step(cfg, shape, make_local_mesh(1, 1, device="cuda"),
                         OptConfig(lr=1e-3, warmup_steps=5, total_steps=100),
                         n_acc=1, masked=True)
state = init_train_state(cfg, built, seed=2009)
data = SyntheticLM(cfg.vocab, 4096, 1, seed=0)
times, losses = [], []
for i in range(int(sys.argv[2]) + 1):
    b = data.next_batch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = built.fn(state, b)
    torch.cuda.synchronize()
    if i:
        times.append(time.perf_counter() - t)
    losses.append(float(m["loss"]))
print("RESULT " + json.dumps({"step_s": times, "losses": losses}))
"""


def run(src: Path, steps: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(src), str(steps)],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=""))
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    trees = {"parent": Path(args.parent).resolve() / "src",
             "change": ROOT / "src"}
    runs = []
    for name in ("parent", "change", "change", "parent"):
        res = run(trees[name], args.steps)
        runs.append(dict(res, tree=name))
        print(f"[{card}] {name}: step s {res['step_s']}", flush=True)
    losses = {r["tree"]: r["losses"] for r in runs}
    assert losses["parent"] == losses["change"], losses
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
