"""Serving launcher: placement of the decode dataflow, then prefill +
continuous-batching decode of an assigned arch at smoke scale.

Port of ``repro/launch/serve.py`` for every family:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 4                      # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --device cpu                      # the plain path on the CPU

As in the reference, ``--smoke`` cannot be turned off: the model served is
the arch's ``SMOKE`` config, with weights drawn from a seeded generator.
Under an MoE arch the slots share the experts' capacity buffers, so a
request's tokens depend on the other requests in flight (see
``serving/engine.py``).  An enc-dec arch (whisper-medium) runs its own
branch, as in the reference: stub frames drawn N(0, 0.02) from seed 0 for
``--requests`` streams of 16 frames, the encoder filling the cross K/V,
then ``--max-new`` greedy decode steps from token 0 with one shared
position.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..core.problem import resolve_device
from ..models.config import SHAPES
from ..models import encdec as ed
from ..models.registry import init_model
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
    model = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    if cfg.family == "encdec":
        frames = torch.from_numpy(np.random.default_rng(0).normal(
            0, 0.02, (args.requests, 16, cfg.d_model)).astype(np.float32))
        cache = ed.init_encdec_cache(cfg, args.requests, 64, 16,
                                     torch.float32, device=device)
        cache, _ = ed.encdec_prefill(cfg, model, frames.to(device), cache)
        tok = torch.zeros((args.requests, 1), dtype=torch.int32,
                          device=device)
        outs = []
        for pos in range(args.max_new):
            logits, cache = ed.encdec_decode_step(cfg, model, tok, cache, pos)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            outs.append(tok[:, 0].cpu().numpy())
        print(f"{args.arch} (enc-dec): decoded {args.max_new} steps x "
              f"{args.requests} streams: {np.stack(outs).T.tolist()}")
        return

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
