"""Where a training microbatch of llama3.2-1b spends its time, on one card.

    python3 tools/train_profile.py [--micro 2] [--all-pairs]

Builds ``chip_smoke.py``'s phase-13 model (llama3.2-1b at full width and
depth, bfloat16 compute, float32 masters drawn from a generator seeded
2009) with a one-sequence step (4,096 tokens, ``n_acc`` 1, remat, the
``masked`` loss), takes one warm-up ``loss_and_grads``, then times and
traces ``--micro`` microbatches (forward, recompute and backward, no
update) and one ``apply_updates`` with ``torch.profiler`` (CPU and CUDA
activities).  Prints, with the card's name and power limit: the host-clock
time per call, the device-busy time, the idle share, the kernel launches
and the top host operators and kernels.  ``--all-pairs`` makes the
chunked attention compute every (q, kv) chunk pair, including those the
causal mask hides whole (as the reference does), for an A/B in one call:
the two must give the same loss and gradients bit for bit.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from serve_profile import breakdown  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import OptConfig, apply_updates  # noqa: E402


def traced(fn, calls, tag, what):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
    breakdown(prof, calls, tag, what,
              1e3 * (time.perf_counter() - t0) / calls)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--all-pairs", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    tag = cs.card()
    cfg = get_config(cs.TRAIN_ARCH)
    shape = ShapeConfig("train_4k", "train", seq_len=cs.TRAIN_SEQ,
                        global_batch=1)
    opt = OptConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    built = build_train_step(cfg, shape, make_local_mesh(1, 1, device="cuda"),
                             opt, n_acc=1, masked=True)
    state = init_train_state(cfg, built, seed=cs.SEED)
    batch = SyntheticLM(cfg.vocab, cs.TRAIN_SEQ, 1, seed=0).next_batch()
    step = built.meta["loss_and_grads"]

    def micro():
        return step(state, batch)

    results = {}
    for all_pairs in ((False, True) if args.all_pairs else (False,)):
        live = attention.live_kv_chunks
        if all_pairs:
            attention.live_kv_chunks = lambda qi, qc, kc, nkc, causal: nkc
        try:
            what = ("microbatch, every chunk pair" if all_pairs
                    else "microbatch")
            results[all_pairs] = traced(micro, args.micro, tag, what)
        finally:
            attention.live_kv_chunks = live
    if args.all_pairs:
        (l0, g0), (l1, g1) = results[False], results[True]
        assert torch.equal(l0, l1), (float(l0), float(l1))
        assert all(torch.equal(g0[k], g1[k]) for k in g0)
        print(f"[{tag}] skipping the chunk pairs the causal mask hides whole "
              f"changes no loss and no gradient bit")
    loss, grads = results[False]
    traced(lambda: apply_updates(opt, state, grads), 1, tag, "apply_updates")
    print(f"[{tag}] loss {float(loss):.6f}; peak device memory "
          f"{torch.cuda.max_memory_allocated()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
