"""Serving launcher: placement of the decode dataflow, then prefill +
continuous-batching decode of an assigned arch at smoke scale.

Port of ``repro/launch/serve.py`` for the dense, VLM and MoE families:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 4                      # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --device cpu                      # the plain path on the CPU

As in the reference, ``--smoke`` cannot be turned off: the model served is
the arch's ``SMOKE`` config, with weights drawn from a seeded generator.
Under an MoE arch the slots share the experts' capacity buffers, so a
request's tokens depend on the other requests in flight (see
``serving/engine.py``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..core.problem import resolve_device
from ..models.config import SHAPES
from ..models.registry import init_model
from ..models.transformer import PENDING
from ..serving import Engine, Request
from .placement import PodTopology, plan_serving


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    full = get_config(args.arch)
    plan = plan_serving(full, SHAPES["decode_32k"], PodTopology(pods=1),
                        requests_per_sec=100.0, device=device)
    if plan:
        print(f"[placement] decode dataflow -> slices {plan.stage_slices}")

    cfg = get_config(args.arch, smoke=True)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{args.arch}: enc-dec serving is not ported yet (ROADMAP.md, "
            f"Queue 1 {PENDING['encdec']})")

    model = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    eng = Engine(cfg, model, n_slots=args.slots, max_len=64,
                 temperature=args.temperature, top_k=20, device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        L = int(rng.integers(4, 10))
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab, L).astype(np.int32),
                           max_new=args.max_new))
    done, ticks = eng.run()
    print(f"{args.arch}: served {len(done)} requests "
          f"({sum(len(r.out) for r in done)} tokens, {ticks} ticks)")


if __name__ == "__main__":
    main()
