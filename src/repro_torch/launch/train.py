"""Training launcher: any assigned arch at smoke scale, on one device.

Port of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 20                 # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 20 --device cpu    # the plain path on the CPU

It plans the model's pipeline through the mapper (``plan_pipeline``: on a
card, the batched superstep kernel), builds the train step, and trains on
``SyntheticLM`` batches through the fault-tolerant ``Trainer``, printing
the reference's two lines.  As in the reference, the data pipeline yields
only ``tokens``, ``labels`` and ``loss_mask``, so the VLM and enc-dec
archs (internvl2-2b, whisper-medium), whose steps also take
``patch_embeds`` or ``frames``, fail: every step raises ``ValueError``,
the trainer restarts ``max_restarts`` times and then raises.  Without
``--smoke`` the launcher asks for the 16 x 16 production mesh, a
``DeviceMesh`` over 256 ranks of the default process group, which raises
``ValueError`` below that (``--production-mesh`` is parsed and, as in the
reference, unused).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Optional

from ..configs import get_config, train_accumulation
from ..core.problem import resolve_device
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models.config import SHAPES, ShapeConfig
from ..optim.adamw import OptConfig
from ..runtime.trainer import Trainer, TrainerConfig
from .mesh import make_local_mesh, make_production_mesh
from .placement import PodTopology, plan_pipeline
from .steps import build_train_step, init_train_state


def main(argv=None, *, inject_failure: Optional[Callable[[int], None]] = None
         ) -> Trainer:
    """Run the launcher on ``argv``; ``inject_failure`` becomes the
    trainer's failure hook.  Returns the trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=[k for k, v in SHAPES.items()
                                                            if v.kind == "train"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires a pod or 256 devices)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        shape = ShapeConfig("train", "train", seq_len=64, global_batch=4)
        mesh = make_local_mesh(1, 1, device=device)
        n_acc = 1
    else:
        shape = SHAPES[args.shape]
        mesh = make_production_mesh(device=device)
        n_acc = train_accumulation(args.arch)

    plan = plan_pipeline(cfg, shape, PodTopology(pods=1), steps_per_sec=0.1,
                         device=device)
    if plan:
        print(f"[placement] stages->slices {plan.stage_slices} "
              f"(lat {plan.latency_us:.1f}us)")

    built = build_train_step(cfg, shape, mesh, OptConfig(
        lr=1e-3, warmup_steps=5, total_steps=max(args.steps, 100)),
        n_acc=n_acc, masked=True)
    state = init_train_state(cfg, built)
    data = Prefetcher(iter(SyntheticLM(cfg.vocab, shape.seq_len,
                                       shape.global_batch, seed=0)))
    tr = Trainer(TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=10),
                 state, built.fn, data, state_shardings=built.in_shardings[0])
    tr.inject_failure = inject_failure
    tr.run(args.steps)
    losses = [m["loss"] for m in tr.metrics_log]
    print(f"{args.arch}: {len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return tr


if __name__ == "__main__":
    main()
