"""Where a decode tick of the serving engine spends its time, on one card.

    python3 tools/serve_profile.py [--ticks 8] [--arch qwen2-0.5b]

Builds ``chip_smoke.py``'s phase-10 model (``--arch``: qwen2-0.5b, or
any arch the engine serves, such as phase 11's deepseek-moe-16b or phase
12's falcon-mamba-7b and zamba2-7b, at full width and depth, float32,
weights from a generator seeded 2009), fills all 8 slots of an ``Engine``
(max_len 512) with the first 8 of phase 10's prompts, and traces
``--ticks`` engine ticks (all slots decoding, none refilled) with
``torch.profiler`` (CPU and CUDA activities), then one 256-token prefill.
Prints, with the card's name and power limit: the host-clock time per
tick, the device-busy time per tick (the sum of the CUDA kernels' device
times), the device's idle share, the kernel launches per tick, and the
operators that take the most host and device time.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.registry import init_model  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402


def breakdown(prof, calls, tag, what, wall_ms):
    """Per-call host and device totals of a trace, and its top operators."""
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = cs.launch_count(prof)
    busy = device_us / 1e3 / calls
    print(f"[{tag}] {what}: {wall_ms:.3f} ms per call on the host clock; "
          f"device busy {busy:.3f} ms per call; idle share "
          f"{1 - busy / wall_ms:.4f}; {launches / calls:.0f} kernel launches "
          f"per call")
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    print(f"[{tag}] {what}, top host operators (self ms per call, calls "
          f"per call): " + "; ".join(
              f"{e.key} {e.self_cpu_time_total / 1e3 / calls:.3f} "
              f"({e.count / calls:.0f})" for e in host))
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:8]
    print(f"[{tag}] {what}, top kernels (device ms per call, launches per "
          f"call): " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3 / calls:.4f} "
              f"({e.count / calls:.0f})" for e in dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--arch", default=cs.SERVE_ARCH,
                    choices=[a for a in ARCHS
                             if get_config(a).family in lm.FAMILIES])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device", file=sys.stderr)
        return 2
    tag = cs.card()
    cfg = get_config(args.arch).with_(dtype="float32")
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(cs.SEED),
                       device="cuda")
    rng = np.random.default_rng(cs.SEED)
    lens = rng.integers(cs.PROMPT_LENS[0], cs.PROMPT_LENS[1] + 1,
                        cs.SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    eng = Engine(cfg, model, n_slots=cs.SERVE_SLOTS, max_len=cs.SERVE_MAX_LEN,
                 device="cuda")
    for i, p in enumerate(prompts[:cs.SERVE_SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new=cs.SERVE_NEW))
    for _ in range(3):  # fill every slot, then warm the decode step
        eng.step()
    assert all(eng.active) and cs.SERVE_NEW > 3 + args.ticks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / args.ticks
    breakdown(prof, args.ticks, tag, f"{cfg.name} engine tick "
              f"({cs.SERVE_SLOTS} slots decoding)", wall)

    long = next(p for p in prompts if len(p) > 192)
    cache = lm.init_lm_cache(cfg, 1, cs.SERVE_MAX_LEN, torch.float32,
                             device="cuda")
    tok = torch.from_numpy(long[None]).cuda()
    lm.lm_prefill(cfg, model, tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.lm_prefill(cfg, model, tok, cache)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    breakdown(prof, 1, tag, f"{cfg.name} prefill of {len(long)} tokens",
              wall)
    print(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
