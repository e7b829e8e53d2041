"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from ``src/repro_torch`` (one ``nvcc``
per source, all started together, into ``build/repro_torch/``) and holds
each bit for bit against its plain PyTorch version on the card: the batched
superstep in every launch regime its plan distinguishes (v split across a
cluster or not, K chunked or not) and over twelve supersteps with its
control word, using the seeded cases of ``tests/torch_kernel_cases.py``.
It times the superstep at B = 1 and B = 64 (n = 1024) and at n = 4096, and
after the main path at every batch size the main path launched.  The two
single-request kernels are held against their plain versions the same way
(the move at the engine's rank blocks, unaligned widths, ties across
cluster splits and all-BIG columns; the place with non-monotone prefixes,
C above BIG and 2^20 rows in chunks) and timed beside an empty kernel built
from ``src/repro_torch/kernels/csrc/empty.cu`` (the launch floor): the move
at (1024, 1024) with warm and cold L2, at the D = 2 and 4 rank blocks and
at (4096, 4096); the place at n = 1024, 4096 and 2^20 (K = 9 and 33).  Then it
drives each path that runs a kernel, with that kernel's launch count reset
just before and read just after:

- online admission through ``OnlinePlacer`` + ``AdmissionPipeline`` on a
  1024-node Waxman network with a 256-arrival stream (the batched superstep
  kernel; its supersteps are also counted by batch size B), replayed with
  ``kernel_impl="plain"``, which must end in the bitwise-same state;
- the decentralized BSP engine ``solve(method="shard_map")`` on one rank
  over 32 distinct requests of that stream (the masked min-plus kernel),
  against its plain rerun and ``leastcost_torch``;
- the op ``place_window`` (the capacity-window place kernel) on the same
  requests' capacity windows;
- every registered backend on the paper's worked example;
- the centralized multi-tenant ``ControlPlane`` on the same network (the
  superstep kernel): four weighted tenants submit 192 requests in all three
  preemption classes over eight pump rounds (micro-batch 64, pipeline depth
  2), with releases, one defrag, one node failed and restored, and a hot
  spot whose class-2 requests must preempt class-0 ones; replayed with
  ``kernel_impl="plain"``, which must return the same rids, tickets,
  ledger and fairness summary;
- the regional (R = 64) and 2-level hierarchical planes on
  ``region_tree(3, 4, 64)`` (n = 4096 in 64 leaves of 64 nodes) replaying
  ``benchmarks/bench_trace.py``'s seeded trace (36 rounds, 12 of warm-up),
  each through the kernel at the region-local n_r = 64 and replayed through
  the plain version, which must end in the same rids, active set, ledger
  and coordination counts; the superstep is then timed at n_r = 64 at
  every batch size the trace launched;
- serving (phase 10): device placement through the superstep kernel
  (``plan_pipeline`` for every arch x shape cell x 1, 2 and 4 pods,
  ``plan_serving`` as ``launch/serve.py`` calls it, the VLM's tree
  dataflow), held bitwise against ``kernel_impl="plain"``; then
  ``launch/serve.py``'s model path at the full width of qwen2-0.5b in
  float32 (24 layers, 494 M parameters from a generator seeded 2009): the
  continuous-batching ``Engine`` (8 slots, max_len 512) serves 32 greedy
  requests with prompts of 16-256 tokens and 32 new tokens each, then 8
  requests at temperature 0.7 and top-k 20 twice from one seed (identical
  outputs), with tokens/s, decode step p50/p95 against the weights' bytes
  over the HBM rate, prefill ms by prompt length and peak memory.  Its
  checks: 4 requests equal a straight-line greedy through ``lm_forward``
  up to their first near tie (top-2 gap at most 1e-3 x max |logit|); the
  prefill logits of 2 prompts of 32 tokens agree with the same weights on
  the host CPU within 1e-3 x max |logit|, and 8 greedy decode steps agree
  wherever the CPU's top-2 gap exceeds 10x that error.  The model layers
  run no TPU kernel's port: the reference computes them in plain ``jnp``;
- the MoE family (phase 11), after phase 10's model is freed:
  ``launch/serve.py --arch`` deepseek-moe-16b and phi3.5-moe-42b-a6.6b on
  the card (``plan_serving`` through the superstep kernel, its slices equal
  to the plain version's, then the SMOKE engine); deepseek-moe-16b at its
  full width and depth in float32 (28 layers, the dense-first one with
  d_ff 10944, 64 routed experts top-6 and 2 shared; 16,375,728,128
  parameters, 65.50 GB, from a generator seeded 2009) under phase 10's
  load, with the decode step held against the bytes of every weight but
  the embedding table (19.30 ms) and the active parameters' (3.13 ms), and
  the pairs the expert capacity drops counted in the first sampled run.
  Phase 10's straight-line check does not hold under MoE (the capacity
  counts the whole call's tokens), so its checks are: (a) a one-slot
  engine's greedy tokens equal ``lm_prefill`` + ``lm_decode_step`` at
  batch 1 up to the first near tie; (b) the model cut to 3 layers (the
  dense-first one and 2 MoE) at full width on the card against its copy on
  the host CPU: prefill logits within 1e-3 x max |logit|, greedy decode,
  and every MoE call's routing equal but for tokens whose k-th and
  (k+1)-th router probabilities lie within 1e-5 of each other; (c) one
  full-width phi3.5-moe layer (16 experts 4096 -> 6400, top-2) on the card
  against the CPU at T = 8 and 256 tokens, output within 1e-3 x max |out|
  and routing equal, with its drops at T = 256 printed;
- the SSM, hybrid and enc-dec families (phase 12), each model freed before
  the next allocates: ``launch/serve.py --arch`` falcon-mamba-7b,
  zamba2-7b and whisper-medium on the card (``plan_serving`` through the
  superstep kernel == plain, then the SMOKE engine or enc-dec decode);
  falcon-mamba-7b (64 Mamba-1 layers, d_model 4096, 7,272,665,088
  parameters) and zamba2-7b (81 Mamba-2 layers, d_model 3584, and one
  shared attention block called at 14 sites; 6,751,130,832 parameters) at
  full width and depth in float32 under phase 10's load, each decode tick
  held against the bytes of its weights, states and attended k/v rows,
  with a 4,096-token prefill timed and the launches per tick traced; (a)
  the engine's greedy tokens equal ``lm_prefill`` + ``lm_decode_step`` at
  batch 1 up to a near tie; (b) a cut (3 layers; zamba2 8, one group and a
  tail of 2) against the host CPU at 256 and 4,096 tokens (the chunked
  scan; the chunked SSD, bfloat16 inside a chunk, held within 5e-2 x max,
  the float32 paths within 1e-3): prefill logits, every cache leaf and 16
  greedy steps.  whisper-medium (24 + 24 layers, 758,707,200 parameters):
  8 streams of 1,500 stub frames, the encoder and the cross K/V, then 128
  greedy decode steps (self cache 448) against each step's bound; stream 0
  against the host CPU: ``enc_out`` and the first logits within 1e-3 x
  max, greedy tokens up to a near tie;
- training (phase 13): ``launch/train.py --smoke --steps 8`` for the eight
  archs its data feeds (``plan_pipeline`` through the superstep kernel,
  its plan equal to the plain version's; finite losses, no failure), one
  of them again with a ``RuntimeError`` injected after its first
  checkpoint (exactly one failure and one restore, and the run finishes),
  and two ``build_train_step`` steps each for internvl2-2b and
  whisper-medium on ``make_batch``; (c) llama3.2-1b cut to 2 layers at
  full width in float32, 2 x 512 tokens, card against the host CPU: loss
  within 1e-4 x |loss|, each gradient leaf within 1e-3 x max |CPU leaf|,
  one ``apply_updates`` within 1e-5 x max; then llama3.2-1b at published
  width and depth (1,235,814,400 parameters, bfloat16 compute, float32
  masters) for 3 steps of 8 x 4,096 tokens in 8 microbatches through
  ``Trainer`` over ``Prefetcher(SyntheticLM)``, each step against its
  FLOP bound at 989 TFLOP/s (``train_flops``), its final 14.8 GB
  checkpoint (under ``build/``, deleted after) restored onto the card
  bitwise, and (d) ``compress_all_reduce`` at world size 1 on the trained
  model's gradients of one sequence (error state == g32 - deq exactly,
  |deq - g32| <= scale);
- the mesh path (phase 14), in an NCCL group of one rank on a free local
  port, on ``make_local_mesh(1, 1)``, a DeviceMesh: (a) llama3.2-1b at
  published width and depth (bfloat16 compute, float32 masters) for 2
  steps of 4 x 4,096 tokens (train_4k's sequence, its batch 256 reduced to
  4) in the published sequence-parallel mode with 2 microbatches through
  the sharded ``build_train_step``, and the same 2 steps through the
  one-device step from the same state and batches: losses and every
  master, m and v leaf bitwise; (b) ``build_prefill_step`` over 2 x 32,768
  tokens (prefill_32k, batch 32 reduced to 2) and 32 ``build_decode_step``
  steps from position 32,000 over a 16 x 32,768-position bfloat16 cache
  (decode_32k, batch 128 reduced to 16; 17.2 GB), each output and cache
  bitwise equal to a direct ``lm_prefill`` / ``lm_decode_step``, the
  decode step's p50/p95 against its bound; then a 2-layer float32 cut
  through both builders, card against the host CPU, within 1e-3 x max;
- the cost model and the dry runs (phase 15): (a) ``launch/dryrun.py`` for
  qwen2-0.5b x ``decode_32k`` on the production single-pod (16 x 16, 256
  ranks) and multi-pod (2 x 16 x 16, 512) meshes of a ``fake`` process
  group, fake tensors (nothing allocated), each cell in its own
  subprocess with ``--device cuda`` and again with ``--device cpu``, all
  four started together: chips, per-device FLOPs, HBM bytes, collectives
  by kind and ``argument_bytes``, the two devices' FLOPs, collectives and
  argument bytes equal (an operator counted differently is printed);
  (b) ``launch/hlo_cost.py`` over one warm ``lm_decode_step`` of phase
  10's qwen2-0.5b float32 engine shape (8 slots, max_len 512) on the card
  with real tensors, its FLOPs and HBM bytes equal to the count on fake
  CPU tensors of the same shapes, and its bound (FLOPs over the float32
  rate outside the tensor cores, 2 x the FP32 lanes' rate, or bytes over
  3.35 TB/s) beside phase 10's decode p50 and the weights' bytes bound;
  (c) ``launch/dryrun.py`` for llama3.2-1b x ``train_4k`` at full width
  and depth (sequence parallel, 2 microbatches, the sharded train step's
  backward included) on the same two meshes, fake ``cuda`` and fake
  ``cpu`` tensors, four subprocesses started together at the start of
  phase 15 (after phase 14's timings) and run on the host beside (a)
  and (b): every cell exits 0,
  FLOPs, collectives and ``argument_bytes`` equal across the two devices,
  the single-pod cell's FLOPs 4.823678e13 per device (the attention on
  each rank's own q heads, every weight gradient on the rank's own
  share); per-device FLOPs, bytes,
  collectives and memory printed; (d) ``launch/dryrun.py`` for
  llama3.2-1b x ``prefill_32k`` cut to 2 layers at its published widths
  (``--n-layers 2``) on the single-pod mesh, fake ``cuda`` and fake
  ``cpu`` tensors, two subprocesses started with (c): FLOPs, collectives
  and ``argument_bytes`` equal across the two devices, and the dense
  products' (``aten.mm``) FLOPs per device equal to the CPU count,
  9.964981e11 (each rank's share of every product: the serving prefill
  sums each row-split product before the residual add); (e)
  ``launch/dryrun.py`` for falcon-mamba-7b x ``decode_32k`` cut to 2
  layers at its published widths on the single-pod mesh, fake ``cuda``
  and fake ``cpu`` tensors, two subprocesses started with (c) and (d):
  FLOPs, collectives and ``argument_bytes`` equal across the two
  devices, and the FLOPs per device equal to the CPU count, 4.768399e8
  (each rank runs its own d_inner channels of every Mamba mixer); (f)
  and (g), the two sharded paths that torch 2.11's DTensor once
  rejected, the same way at 256 fake ranks, started with (c)-(e):
  falcon-mamba-7b x ``train_4k`` cut to 2 layers (the embedding's rows
  and their gradient on local tensors), 1.289349e13 FLOPs per device,
  and zamba2-7b x ``decode_32k`` cut to 2 layers (one call site of the
  shared block, its kv heads split over the model axis: the decode
  attention on local shards), 7.256310e8; (h) the same way for
  deepseek-moe-16b x ``train_4k`` cut to 2 layers (one dense, one MoE:
  each rank routes its own tokens and runs its own experts on its own
  capacity slots), 1.193249e13 FLOPs per device; (i) the same way for
  internvl2-2b x ``train_4k`` cut to 2 layers (sequence parallel: the LM
  head over 92,553 columns, which the model axis does not divide, and the
  loss run on each rank's own sequence rows), 1.001846e13 FLOPs per
  device; (j) the same way for qwen2-0.5b x ``train_4k`` cut to 2 layers
  (sequence parallel: its q, whose 14 heads the model axis does not
  split into whole kv groups, reaches the attention replicated and each
  rank runs its own q head, 1 of 14), 5.007261e12 FLOPs per device.
Any failure raises and exits nonzero.  Without a CUDA device it exits
nonzero before printing any result.

Output: timings and counts, each tagged with the card's name and power
limit; then one JSON line of per-kernel numbers; then the card's name and
power limit; and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 2009
N_NODES = 1024  # waxman(1024): the smallest network benchmarks/bench_trace.py replays
P = 8
POOL = 192
ARRIVALS = 256  # with its plain replay, the script's longest phase on a slow host
MICRO_BATCH = 64
RELEASE_P = 0.2
# H100 SXM: 132 SMs x 128 FP32 lanes; 3.35 TB/s HBM3 (NVIDIA data sheet)
SMS, LANES, HBM_BYTES_S = 132, 128, 3.35e12
LANE_OPS_S = SMS * LANES * 1.98e9  # at the H100 SXM boost clock, 1980 MHz
OPS_PER_CANDIDATE = 4  # add, clamp, bandwidth compare, running-min select
ENGINE_REQUESTS = 32  # distinct requests the shard_map phase solves


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> tuple[float, float]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    cur, mx = out.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(mx)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call of ``fn`` without the host's launch overhead:
    ``calls`` calls captured in one CUDA graph, replayed ``replays`` times
    between two CUDA events.  ``cuda_ms`` of a call that takes less device
    time than the host needs to issue it measures the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (calls * replays)


def assert_state_equal(got, want, what):
    for g, w, field in zip(got, want, ("C", "par_v", "par_j")):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"kernel != plain on {what}: {field} differs "
                                 f"in {bad} entries")


def check_kernel(tk, tag):
    """Phase 2: the superstep kernel against the plain version, bitwise, in
    every launch regime its plan distinguishes (v split or not, K chunked
    or not), and over twelve supersteps with the control word."""
    from torch_kernel_cases import (random_state, relaxation_state,
                                    split_tie_state, tie_state)

    split_args, (first, second) = split_tie_state(N_NODES)
    cases = [
        ("random", random_state(3, 12, 6, 0)),
        ("random", random_state(4, 40, 7, 1)),
        ("ties", tie_state()),
        ("first-v ties across v splits", split_args),
        ("big_overflow", random_state(2, 10, 5, 9, big_frac=1.0)),
        ("big_overflow B=1", random_state(1, N_NODES, P + 1, 7, big_frac=1.0)),
        ("big_overflow B=64", random_state(64, 300, P + 1, 8, big_frac=1.0)),
        ("ragged_n", random_state(5, 45, 9, 2)),
        ("ragged_n", random_state(3, 1000, 5, 3)),
        ("K=2", random_state(1, 33, 2, 4)),
        ("K=2 B=1", random_state(1, N_NODES, 2, 9)),
        ("K=33", random_state(5, 130, 33, 10)),
        ("K=33 B=1", random_state(1, N_NODES, 33, 11)),
        ("B=1", random_state(1, N_NODES, P + 1, 12)),
        ("B=1 n=4096", random_state(1, 4096, P + 1, 13)),
        ("main_shape", random_state(64, N_NODES, P + 1, 5)),
        ("n4096", random_state(8, 4096, P + 1, 6)),
    ]
    for name, args in cases:
        dev = [torch.from_numpy(a).cuda() for a in args]
        ws = tk.make_workspace(*args[0].shape, dev[0].device)
        got = tk.batched_superstep(*dev, workspace=ws)
        torch.cuda.synchronize()
        assert_state_equal(got, tk.batched_superstep_plain(*dev), name)
        assert ws.ticket.item() == 0, "retire ticket not reset"
        plan = ws.plan
        if name.startswith("first-v"):
            others = [w for w in range(N_NODES) if w not in (first, second)]
            assert first // plan.v_chunk != second // plan.v_chunk, plan
            assert (got[1][0, others, 1:3] == first).all()
        print(f"[{tag}] kernel == plain bitwise: {name} "
              f"B,n,K={tuple(args[0].shape)} (tb={plan.tb}, v splits "
              f"{plan.splits}, k chunks {plan.kchunks}, {plan.blocks} blocks)")
    for B, n, K in ((1, N_NODES, P + 1), (4, 200, P + 1)):
        for max_rounds in (50, 3):
            args = [torch.from_numpy(a).cuda()
                    for a in relaxation_state(B, n, K, 8)]
            ws = tk.make_workspace(B, n, K, args[0].device)
            fk = torch.tensor([0, 1, 0, max_rounds], dtype=torch.int32,
                              device=args[0].device)
            fp = fk.clone()
            sk = sp = tuple(args[:3])
            for step in range(12):
                sk = tk.batched_superstep(*sk, *args[3:], flags=fk,
                                          workspace=ws)
                sp = tk.plain_superstep(*sp, *args[3:], flags=fp)
                torch.cuda.synchronize()
                assert_state_equal(sk, sp, f"superstep {step} of a sequence")
                assert fk.tolist() == fp.tolist(), (step, fk, fp)
            t, active = fk[:2].tolist()
            assert active == 0 and (t == 3 if max_rounds == 3 else 3 < t < 12)
            print(f"[{tag}] kernel == plain bitwise over 12 supersteps with "
                  f"the control word: B,n,K={(B, n, K)}, max_rounds "
                  f"{max_rounds}, stopped after {t} rounds")


def host_issue_ms(fn, calls: int = 200) -> float:
    """Host time to issue one call of ``fn``: the host clock around
    ``calls`` calls with no synchronization in between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return ms


def time_kernel(tk, tag, B, n, K, seed):
    """The superstep kernel's device time at (B, n, K), launched as the
    main path launches it (one workspace, the control word): the CUDA-graph
    replay (no host issue gaps) beside CUDA events over back-to-back eager
    calls, which equal device time only while a superstep outlasts its
    host issue time.  Every call improves the same input state, so the
    control word stays active throughout."""
    from torch_kernel_cases import random_state

    dev = [torch.from_numpy(a).cuda()
           for a in random_state(B, n, K, seed, big_frac=0.6)]
    ws = tk.make_workspace(B, n, K, dev[0].device)  # one per relaxation
    flags = torch.tensor([0, 1, 0, 2**30], dtype=torch.int32,
                         device=dev[0].device)
    step = lambda: tk.batched_superstep(  # noqa: E731
        *dev, flags=flags, workspace=ws)
    eager_ms = cuda_ms(step, 50)
    issue_ms = host_issue_ms(step)
    ms = graph_ms(step)
    for _ in range(int(1000 / ms) + 1):  # ~1 s of queued supersteps
        step()
    loaded_mhz = sm_clock_mhz()[0]  # read while the card runs the kernel
    torch.cuda.synchronize()
    assert flags[1].item() == 1, f"the control word went inactive: {flags}"
    plain_ms = cuda_ms(lambda: tk.batched_superstep_plain(*dev), 5)
    got = tk.batched_superstep(*dev, workspace=ws)
    want = tk.batched_superstep_plain(*dev)
    err = float((got[0] - want[0]).abs().max())
    candidates = B * n * n * K
    ops_s = LANE_OPS_S
    nbytes = 4 * (6 * B * n * K + 2 * n * n + n + 2 * B * K)
    bound_ops_ms = 1e3 * OPS_PER_CANDIDATE * candidates / ops_s
    bound_bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    at_clock_ms = bound_ops_ms * 1980.0 / loaded_mhz
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    plan = ws.plan
    print(f"[{tag}] superstep B={B} n={n} K={K} (one launch of {plan.blocks} "
          f"blocks: tb={plan.tb}, v splits {plan.splits}, stages "
          f"{plan.stages}): kernel {ms:.4f} ms (CUDA "
          f"graph replays; back-to-back eager calls {eager_ms:.4f} ms; host "
          f"issue {issue_ms:.4f} ms per call), plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4g} ms ({candidates:.3e} candidates x "
          f"{OPS_PER_CANDIDATE} ops over {ops_s:.3e} lane-ops/s = "
          f"{bound_ops_ms:.4g} ms; bytes bound {bound_bytes_ms:.4g} ms); "
          f"kernel / bound {ms / bound_ms:.2f}x; SM clock under this kernel "
          f"{loaded_mhz:.0f} MHz, operations bound at that clock "
          f"{at_clock_ms:.4g} ms")
    return dict(ms=ms, eager_ms=eager_ms, issue_ms=issue_ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                bound_by="operations" if bound_ops_ms >= bound_bytes_ms
                else "bytes", candidates=candidates)


# ---------------------------------------------------------------------------
# The single-request kernels: masked min-plus move and capacity-window place
# ---------------------------------------------------------------------------

BIG32 = np.float32(1e18)
L2_FLUSH_BYTES = 256 * 2**20  # written between calls for a cold L2 (50 MB)
PLACE_CHUNK = 2**16  # rows per plain-version check at the throughput shapes


def on_card(args):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]


def assert_same(got, want, what):
    torch.cuda.synchronize()
    for g, w, field in zip(got, want, ("value", "argmin")):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"kernel != plain on {what}: {field} differs "
                                 f"in {bad} entries")


def check_minplus(tm, tag):
    """The masked min-plus kernel against its plain version, bitwise: one
    launch per call at every shape, the engine's rank blocks at D = 1, 2
    and 4, unaligned widths, equal minima in different cluster splits and
    columns whose candidates are all at or above BIG."""
    from torch_kernel_cases import (minplus_big_columns, minplus_block,
                                    minplus_split_tie)

    cases = [(f"n={n} K={K}", minplus_block(n, n, K, n * 1000 + K))
             for n, K in [(8, 2), (17, 3), (50, 7), (128, 9), (130, 3),
                          (256, 33), (300, 17)]]
    cases += [(f"rank block n_v={N_NODES} n_w={w} K={K}",
               minplus_block(N_NODES, w, K, w * 100 + K))
              for w in (N_NODES, N_NODES // 2, N_NODES // 4, 17, 130, 300)
              for K in (2, P + 1, 33)]
    infeasible = minplus_block(32, 32, 4, 7)
    infeasible[3][:] = BIG32
    ties = [np.zeros((16, 3), np.float32), np.ones((16, 16), np.float32),
            np.full((16, 16), 100.0, np.float32),
            np.asarray([BIG32, 1.0, 1.0], np.float32)]
    cases += [("all-infeasible columns", infeasible), ("first-v ties", ties)]
    for name, args in cases:
        dev = on_card(args)
        before = tm.LAUNCHES
        got = tm.masked_minplus_cuda(*dev)
        assert tm.LAUNCHES == before + 1, "more than one launch per call"
        assert_same(got, tm.masked_minplus_plain(*dev), name)
        if name == "all-infeasible columns":
            assert (got[0] == float(BIG32)).all() and (got[1] == 0).all()
        if name == "first-v ties":
            assert (got[1][:, 1:] == 0).all()
        print(f"[{tag}] masked_minplus kernel == plain bitwise: {name}")
    for n_w, K in ((N_NODES, P + 1), (N_NODES // 4, P + 1), (130, 33)):
        args, (first, second) = minplus_split_tie(N_NODES, n_w, K)
        plan = tm._plan_on(torch.cuda.current_device(), N_NODES, n_w, K)
        assert first // plan.v_chunk != second // plan.v_chunk, plan
        got = tm.masked_minplus_cuda(*on_card(args))
        assert_same(got, tm.masked_minplus_plain(*on_card(args)), "split ties")
        assert (got[1] == first).all() and (got[0] == 1.0).all()
        args, cols = minplus_big_columns(N_NODES, n_w, K, n_w + K)
        got = tm.masked_minplus_cuda(*on_card(args))
        assert_same(got, tm.masked_minplus_plain(*on_card(args)), "BIG columns")
        c = torch.from_numpy(cols).cuda()
        assert (got[0][c] == float(BIG32)).all() and (got[1][c] == 0).all()
        print(f"[{tag}] masked_minplus kernel == plain bitwise: first v wins "
              f"across {plan.splits} cluster splits (v {first} and {second}) "
              f"and all-BIG columns give (BIG, 0), n_w={n_w} K={K}")
    # the engine's case: a rank's column block of the square problem
    sq = on_card(minplus_block(N_NODES, N_NODES, P + 1, 21))
    full = tm.masked_minplus_cuda(*sq)
    lo, hi = N_NODES // 2, N_NODES // 2 + N_NODES // 4
    cols = [sq[0], sq[1][:, lo:hi].contiguous(), sq[2][:, lo:hi].contiguous(),
            sq[3]]
    block = tm.masked_minplus_cuda(*cols)
    assert_same(full, tm.masked_minplus_plain(*sq), "square (plain)")
    assert_same(block, (full[0][lo:hi], full[1][lo:hi]), "column block")
    assert_same(block, tm.masked_minplus_plain(*cols), "column block (plain)")
    print(f"[{tag}] masked_minplus kernel == plain bitwise: rectangular "
          f"n_v={N_NODES} n_w={hi - lo} block == columns {lo}:{hi} of the "
          f"square result")


def place_chunks_equal(tp, args, what):
    """The place kernel on the whole input against the plain version on
    row chunks (the plain version's (v, k, j) block would not fit); returns
    the largest value difference over the chunks."""
    got = tp.place_window_cuda(*args)
    C, cap, prefix = args
    err = 0.0
    for lo in range(0, C.shape[0], PLACE_CHUNK):
        hi = lo + PLACE_CHUNK
        want = tp.place_window_plain(C[lo:hi], cap[lo:hi], prefix)
        assert_same((got[0][lo:hi], got[1][lo:hi]), want,
                    f"{what} rows {lo}:{hi}")
        err = max(err, float((got[0][lo:hi] - want[0]).abs().max()))
    return err


def check_place(tp, tag):
    """The capacity-window place kernel against its plain version."""
    from torch_kernel_cases import (place_above_big, place_instance,
                                    place_nonmonotone, place_tie_instance)

    cases = [(f"n={n} K={K}", place_instance(n, K, n + K))
             for n, K in [(10, 3), (64, 9), (130, 7), (256, 17), (300, 33)]]
    cases += [(f"non-monotone prefix n={n} K={K}", place_nonmonotone(n, K, n))
              for n, K in [(300, 9), (1000, 33), (64, 40)]]
    cases += [(f"C above BIG n={n} K={K}", place_above_big(n, K, n))
              for n, K in [(300, 9), (129, 33), (64, 40)]]
    cases.append(("first-j ties + a row with no feasible j",
                  place_tie_instance()))
    for name, args in cases:
        dev = on_card(args)
        got = tp.place_window_cuda(*dev)
        assert_same(got, tp.place_window_plain(*dev), name)
        if name.startswith("first-j"):
            assert got[1][0].tolist() == [0] * 5
            assert got[1][1].tolist() == [0, 1, 1, 1, 1]
            assert (got[0][3] == float(BIG32)).all() and (got[1][3] == 0).all()
        print(f"[{tag}] place_window kernel == plain bitwise: {name}")
    for K in (P + 1, 33):
        place_chunks_equal(tp, on_card(place_instance(2**20, K, K)),
                           f"n=2^20 K={K}")
        print(f"[{tag}] place_window kernel == plain bitwise: n=2^20 K={K} "
              f"(plain version in chunks of {PLACE_CHUNK} rows)")


def empty_floor(root, tag):
    """Device time of an empty kernel (one block, and one full wave of 264
    blocks) in the CUDA-graph harness: the floor of any launch."""
    from repro_torch.kernels import _build

    lib = _build.load(root / "src/repro_torch/kernels/csrc/empty.cu").lib
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    out = {}
    for blocks in (1, 2 * SMS):
        def launch():
            err = lib.empty_launch(blocks,
                                   torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        out[blocks] = graph_ms(launch, calls=50)
    print(f"[{tag}] empty kernel (launch floor): {out[1]:.5f} ms with 1 "
          f"block, {out[2 * SMS]:.5f} ms with {2 * SMS} blocks (CUDA graph "
          f"replays)")
    return out[1]


def cold_ms(fn, flush):
    """Device time of ``fn`` with L2 cold: a graph of (flush, fn) minus a
    graph of the flush alone, the flush writing ``L2_FLUSH_BYTES``."""
    both = graph_ms(lambda: (flush.zero_(), fn()), calls=10, replays=10)
    alone = graph_ms(flush.zero_, calls=10, replays=10)
    return both - alone


def time_single(tag, name, kernel, plain, args, nbytes, ops, floor_ms,
                flush=None, check=None):
    """Kernel device time (CUDA graph replays, warm L2: the engine reuses
    its link columns across supersteps) and, with ``flush``, cold; the
    plain version's (None skips its time) and the card's bound; also the
    eager per-call time, which the host's issue rate sets.  The timed
    inputs are held against the plain version: whole, or by ``check``
    (which returns the largest value difference) where ``plain`` is None."""
    eager_ms = cuda_ms(lambda: kernel(*args), 200)
    ms = graph_ms(lambda: kernel(*args))
    plain_ms = (None if plain is None else
                graph_ms(lambda: plain(*args), calls=5, replays=4))
    if plain is not None:
        got, want = kernel(*args), plain(*args)
        assert_same(got, want, f"{name} timing inputs")
        err = float((got[0] - want[0]).abs().max())
    else:
        err = check(args)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    ops_ms = 1e3 * ops / LANE_OPS_S
    out = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               shape=[list(a.shape) for a in args[:2]])
    if flush is not None:
        out["cold_ms"] = cold_ms(lambda: kernel(*args), flush)
    print(f"[{tag}] {name} {tuple(args[0].shape)} x {tuple(args[1].shape)}: "
          f"kernel {ms:.5f} ms"
          + ("" if flush is None else f" (L2 cold {out['cold_ms']:.5f} ms)")
          + (", plain not timed" if plain is None else
             f", plain {plain_ms:.4f} ms")
          + f" (device time, CUDA graph replays); eager wrapper call "
          f"{eager_ms:.4f} ms; bound {out['bound_ms']:.5f} ms by "
          f"{out['bound_by']} ({nbytes:.4g} bytes over {HBM_BYTES_S:.3g} B/s "
          f"= {bytes_ms:.5f} ms; {ops:.4g} ops over {LANE_OPS_S:.4g} "
          f"lane-ops/s = {ops_ms:.5f} ms); kernel / bound "
          f"{ms / out['bound_ms']:.2f}x; kernel / empty-kernel floor "
          f"{ms / floor_ms:.2f}x")
    return out


def minplus_cost(n_v, n_w, K):
    """Bytes (each input read once, each output written once) and
    operations of one move call."""
    return (4 * (2 * n_v * n_w + n_v * K + K) + 8 * n_w * K,
            OPS_PER_CANDIDATE * n_v * n_w * K)


def place_cost(n, K):
    """Bytes and operations of one place call: the candidates j <= k."""
    return n * K * 12 + n * 4 + K * 4, OPS_PER_CANDIDATE * n * K * (K + 1) // 2


def time_minplus(tm, tag, n_v, n_w, K, seed, floor_ms, flush=None):
    from torch_kernel_cases import minplus_block

    args = on_card(minplus_block(n_v, n_w, K, seed))
    return time_single(tag, "masked_minplus", tm.masked_minplus_cuda,
                       tm.masked_minplus_plain, args,
                       *minplus_cost(n_v, n_w, K), floor_ms, flush)


def time_place(tp, tag, n, K, seed, floor_ms):
    from torch_kernel_cases import place_instance

    args = on_card(place_instance(n, K, seed))
    if n <= 4096:
        return time_single(tag, "place_window", tp.place_window_cuda,
                           tp.place_window_plain, args, *place_cost(n, K),
                           floor_ms)
    return time_single(
        tag, "place_window", tp.place_window_cuda, None, args,
        *place_cost(n, K), floor_ms,
        check=lambda a: place_chunks_equal(tp, a, f"n={n} K={K} timing inputs"))


def distinct_requests(stream, count):
    out, seen = [], set()
    for df in stream:
        if id(df) not in seen:
            seen.add(id(df))
            out.append(df)
        if len(out) == count:
            break
    return out


def engine_phase(T, tm, rg, dfs, tag, fallbacks):
    """The decentralized engine on one rank through the kernel, its plain
    rerun, and leastcost_torch on the same requests."""
    T.solve(rg, dfs[0], method="shard_map")  # warm-up, not counted
    torch.cuda.synchronize()
    runs = {}
    for impl in ("cuda", "plain"):
        fallbacks[:] = [0, 0.0]
        tm.LAUNCHES = 0
        out, ms = [], []
        for df in dfs:
            t0 = time.perf_counter()
            out.append(T.solve(rg, df, method="shard_map", kernel_impl=impl))
            ms.append(1e3 * (time.perf_counter() - t0))
        runs[impl] = dict(out=out, ms=ms, launches=tm.LAUNCHES,
                          fallbacks=list(fallbacks))
    fallbacks[:] = [0, 0.0]
    lc_out, lc_ms = [], []
    for df in dfs:
        t0 = time.perf_counter()
        lc_out.append(T.solve(rg, df, method="leastcost_torch"))
        lc_ms.append(1e3 * (time.perf_counter() - t0))
    lc_fb = list(fallbacks)

    kern, plain = runs["cuda"], runs["plain"]
    supersteps = [st.rounds for _, st in kern["out"]]
    assert kern["launches"] > 0, "the engine launched no masked_minplus kernel"
    assert kern["launches"] == sum(supersteps), (kern["launches"], supersteps)
    assert plain["launches"] == 0, "the plain rerun launched the kernel"
    first_diff = None
    for i, ((m, st), (mp, sp), (ml, sl)) in enumerate(
            zip(kern["out"], plain["out"], lc_out)):
        assert st.kernel_impl == "cuda" and sp.kernel_impl == "plain"
        assert m == mp, (i, m, mp)
        for f in ("rounds", "messages_sent", "messages_cross_device",
                  "max_set_size"):
            assert getattr(st, f) == getattr(sp, f), (i, f)
        assert (m is None) == (ml is None), (i, m, ml)
        if m is not None:
            assert abs(m.cost - ml.cost) <= 1e-3, (i, m.cost, ml.cost)
        if st.rounds != sl.rounds and first_diff is None:
            first_diff = (i, st.rounds, sl.rounds)
    feasible = sum(m is not None for m, _ in kern["out"])
    msgs = [st.messages_sent for _, st in kern["out"]]
    print(f"[{tag}] shard_map (D=1) on waxman({rg.n}) over {len(dfs)} "
          f"distinct requests (p={P}): {feasible} mapped; kernel run == plain "
          f"run (mappings, supersteps, messages_total, messages_cross_device, "
          f"max_set_size); costs == leastcost_torch within 1e-3")
    print(f"[{tag}] shard_map supersteps per solve mean "
          f"{np.mean(supersteps):.2f} (min {min(supersteps)}, max "
          f"{max(supersteps)}, total {sum(supersteps)}); masked_minplus "
          f"launches {kern['launches']} == total supersteps; messages_total "
          f"mean {np.mean(msgs):.1f}; supersteps == leastcost_torch rounds: "
          + ("all requests" if first_diff is None else
             f"no, first at request {first_diff[0]} ({first_diff[1]} vs "
             f"{first_diff[2]})"))
    for name, ms, fb in (("shard_map kernel", kern["ms"], kern["fallbacks"]),
                         ("shard_map plain", plain["ms"], plain["fallbacks"]),
                         ("leastcost_torch", lc_ms, lc_fb)):
        print(f"[{tag}] {name}: per-solve wall ms mean {np.mean(ms):.2f} "
              f"median {np.median(ms):.2f} max {max(ms):.2f}; reconstruct "
              f"fallbacks {fb[0]} taking {fb[1]:.2f} s")
    return kern


def superstep_split(lc, dist_mod, tm, rg, df, tag):
    """Device time of one engine superstep on one rank and of its parts."""
    from repro_torch.core.problem import creq_prefix, finite_lat

    n, K = rg.n, df.p + 1
    C = np.full((n, K), BIG32, np.float32)
    C[df.src, 0] = 0.0
    cap = torch.from_numpy(rg.cap.astype(np.float32)).cuda()
    lat = torch.from_numpy(finite_lat(rg)).cuda()
    bw = torch.from_numpy(rg.bw.astype(np.float32)).cuda()
    prefix = torch.from_numpy(creq_prefix(df).astype(np.float32)).cuda()
    breq_k = torch.from_numpy(np.concatenate(
        [[BIG32], df.breq, [BIG32]]).astype(np.float32)).cuda()
    dev = cap.device
    deg = torch.ones((n, 2), dtype=torch.float32, device=dev)
    Ct = torch.from_numpy(C).cuda()
    pv = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    msgs = torch.zeros(2, dtype=torch.float32, device=dev)
    P_, _ = lc._place_step(Ct, cap, prefix)
    parts = {
        "superstep": lambda: dist_mod._dist_body(
            Ct, pv, pv, msgs, cap, lat, bw, prefix, breq_k, deg,
            move=tm.masked_minplus_cuda, group=None, D=1),
        "plain-torch place step": lambda: lc._place_step(Ct, cap, prefix),
        "masked_minplus move": lambda: tm.masked_minplus_cuda(
            P_, lat, bw, breq_k),
    }
    for name, fn in parts.items():
        print(f"[{tag}] shard_map {name} at n={n} K={K} (D=1): eager "
              f"{cuda_ms(fn, 50):.4f} ms per call (CUDA events over 50 "
              f"calls: the host's issue rate), device {graph_ms(fn):.4f} ms "
              f"(CUDA graph replays)")


def place_op_phase(tp, rg, dfs, tag):
    """The op ``place_window`` on each request's capacity windows over the
    network's capacities, with a seeded frontier."""
    from repro_torch.core.problem import creq_prefix
    from repro_torch.kernels.place import place_window
    from torch_kernel_cases import place_instance

    cap = torch.from_numpy(rg.cap.astype(np.float32)).cuda()
    inputs = []
    for i, df in enumerate(dfs):
        C = place_instance(rg.n, df.p + 1, 100 + i)[0]
        prefix = creq_prefix(df).astype(np.float32)
        inputs.append((torch.from_numpy(C).cuda(),
                       torch.from_numpy(prefix).cuda()))
    torch.cuda.synchronize()
    tp.LAUNCHES = 0
    outs = [place_window(C, cap, prefix) for C, prefix in inputs]
    launches = tp.LAUNCHES
    assert launches == len(dfs), launches
    for (C, prefix), got in zip(inputs, outs):
        assert_same(got, tp.place_window_plain(C, cap, prefix), "the op")
    print(f"[{tag}] place_window op on {len(dfs)} requests' windows over "
          f"waxman({rg.n}) capacities: {launches} kernel launches, each "
          f"== plain bitwise")
    return launches


def paper_phase(T, tag):
    """Every registered backend on the paper's worked example."""
    rg, df = T.paper_example()
    costs = {}
    for method in T.backends():
        m, st = T.solve(rg, df, method=method)
        costs[method] = None if m is None else m.cost
        print(f"[{tag}] paper example, {method}: cost "
              f"{'none' if m is None else f'{m.cost:.2f}'} rounds {st.rounds} "
              f"messages {st.messages_sent} kernel_impl {st.kernel_impl!r}")
    for method in ("exact", "leastcost_python", "leastcost_torch",
                   "shard_map"):
        assert costs[method] is not None and abs(costs[method] - 4.0) < 1e-6, \
            (method, costs[method])


class DeviceWaits:
    """Host seconds spent waiting on the device in ``_Relaxation.finish``
    (the only place the admission path blocks on a solve) while inside."""

    def __init__(self, lc):
        self.lc, self.s = lc, 0.0

    def __enter__(self):
        self.inner = inner = self.lc._Relaxation.finish

        def timed(relax):
            t0 = time.perf_counter()
            try:
                return inner(relax)
            finally:
                self.s += time.perf_counter() - t0

        self.lc._Relaxation.finish = timed
        return self

    def __exit__(self, *exc):
        self.lc._Relaxation.finish = self.inner


def make_stream(T, rg):
    pool = [T.random_dataflow(rg, P, seed=SEED + 1 + i) for i in range(POOL)]
    rng = np.random.default_rng(SEED)
    return [pool[int(i)] for i in rng.integers(0, POOL, ARRIVALS)]


def make_placer(T, rg, kernel_impl, device=None):
    """A warmed-up placer (kernel built, every batch bucket touched).
    ``device="cpu"`` rehearses the main path without a card."""
    placer = T.OnlinePlacer(rg, kernel_impl=kernel_impl, device=device)
    placer.warmup(max_batch=MICRO_BATCH, p=P)
    return placer


def drive(placer, stream, lc_module):
    """The main path: a seeded arrival stream through the pipeline, with
    releases after each micro-batch and one node failure mid-run."""
    from repro_torch.core import AdmissionPipeline

    pipe = AdmissionPipeline(placer, depth=2)
    rng = np.random.default_rng(SEED + 7)
    commit_ms, out = [], []
    inner_commit = placer.commit_admit

    def timed_commit(pending):
        t0 = time.perf_counter()
        r = inner_commit(pending)
        commit_ms.append(1e3 * (time.perf_counter() - t0))
        return r

    placer.commit_admit = timed_commit
    failed = None
    batches = [stream[i:i + MICRO_BATCH]
               for i in range(0, len(stream), MICRO_BATCH)]
    t0 = time.perf_counter()
    with DeviceWaits(lc_module) as waits:
        for bi, batch in enumerate(batches):
            for _, tickets in pipe.push(batch):
                out.extend(tickets)
            for tid in sorted(placer.tickets):
                if rng.random() < RELEASE_P:
                    placer.release(tid)
            if bi == len(batches) // 2:
                use = {}
                for t in placer.tickets.values():
                    for v in t.mapping.route[1:-1]:
                        use[v] = use.get(v, 0) + 1
                failed = max(sorted(use), key=use.get)
                remapped, dropped = placer.fail_node(failed)
                out.extend(remapped)
            if failed is not None and bi == len(batches) // 2 + 2:
                placer.restore_node(failed)
        for _, tickets in pipe.flush():
            out.extend(tickets)
        if placer.device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(wall_s=wall, commit_ms=commit_ms, wait_s=waits.s,
                     failed_node=failed)


def check_dispatch_async(T, rg, stream, tag):
    """``dispatch_admit`` must enqueue its solve without synchronizing the
    host with the card (the pipeline overlaps it with the previous commit),
    including the residual delta sync after commits."""
    placer = T.OnlinePlacer(rg)
    placer.commit_admit(placer.dispatch_admit(stream[:8]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any synchronizing op raises
    try:
        t0 = time.perf_counter()
        pending = placer.dispatch_admit(stream[8:8 + MICRO_BATCH])
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert placer.res.sync_stats["delta_syncs"] > 0
    placer.commit_admit(pending)
    print(f"[{tag}] dispatch_admit of {MICRO_BATCH} requests returned in "
          f"{ms:.2f} ms with no host-device synchronization")


# ---------------------------------------------------------------------------
# The control planes: centralized (phase 8), regional and hierarchical
# (phase 9)
# ---------------------------------------------------------------------------

PLANE_TENANTS = (("svc-a", 4.0), ("svc-b", 2.0), ("batch", 1.0),
                 ("edge", 0.5))
PLANE_ROUNDS = 8  # pump rounds of phase 8
PLANE_PER_ROUND = 24  # submits per round: 192 requests
TRACE_TENANTS = ("svc-a", "svc-b", "batch", "edge")
TRACE_ROUNDS, TRACE_WARMUP, TRACE_RATE = 36, 12, 12.0


def canon(x):
    """A comparable form of what a plane returns (tickets, spanning
    tickets, requests, ledgers): dataclasses by name and fields, arrays as
    lists, floats exact."""
    import dataclasses
    from types import MappingProxyType

    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (dict, MappingProxyType)):
        return sorted((canon(k), canon(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, [(f.name, canon(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)])
    raise TypeError(f"no canonical form for {type(x).__name__}")


def impl_cfg(kernel_impl):
    return {} if kernel_impl is None else {"kernel_impl": kernel_impl}


def hot_requests(T, rg, count):
    """``count`` equal requests between two nodes, out of the node with the
    fewest links, each hop needing 0.9 of that node's widest link: the few
    links that can carry one fill up, so later arrivals are rejected unless
    they may preempt (and fit where a preempted one was)."""
    deg = (rg.bw > 0).sum(1)
    src = int(np.argmin(np.where(deg > 0, deg, rg.n)))
    dst = (src + rg.n // 2) % rg.n
    breq = np.full(3, np.float32(0.9) * rg.bw[src].max(), np.float32)
    creq = np.asarray([0.0, 0.5, 0.5, 0.0], np.float32)
    return [T.DataflowPath(creq, breq, src, dst) for _ in range(count)]


def plane_script(T, TS, rg, pool, kernel_impl, device="cuda",
                 rounds=PLANE_ROUNDS, per_round=PLANE_PER_ROUND, hot=6):
    """Phase 8: four weighted tenants submit requests of classes 1 and 2
    to the centralized plane over ``rounds`` pump rounds, with releases,
    one defrag and one node failed and restored; and a hot spot: first
    ``hot`` class-0 requests out of one thin node, held to the end, then
    ``hot`` class-2 ones that can enter only by preempting them.  Returns
    the plane and every outcome in comparable form."""
    cp = TS.ControlPlane(rg, device=device, micro_batch=MICRO_BATCH,
                         pipeline_depth=2, preempt=True,
                         **impl_cfg(kernel_impl))
    for name, weight in PLANE_TENANTS:
        cp.register_tenant(name, weight=weight)
    rng = np.random.default_rng(SEED + 8)
    hot_dfs = hot_requests(T, rg, 2 * hot)
    out, failed, held = [], None, set()
    for r in range(rounds):
        # the hot spot's class-0 flows arrive first and are held to the end
        burst = {0: ("svc-a", 0), rounds - 2: ("svc-b", 2)}.get(r)
        for i in range(per_round):
            if burst is not None and i < hot:
                tenant, klass = burst
                df = hot_dfs[i + (hot if klass else 0)]
            else:
                tenant = PLANE_TENANTS[int(rng.integers(len(PLANE_TENANTS)))][0]
                df = pool[int(rng.integers(len(pool)))]
                klass = 1 + int(rng.integers(2))  # class 0 is the hot spot's
            rid = cp.submit(tenant, df, klass=klass)
            out.append(("rid", rid))
            if burst is not None and i < hot and klass == 0:
                held.add(rid)
        out.append(("pump", canon(cp.pump(rounds=1))))
        for rid in cp.active_ids():
            if rng.random() < RELEASE_P / 2 and rid not in held:
                cp.release(rid)
        if r == rounds // 2 - 1:
            out.append(("defrag", canon(cp.defrag())))
        if r == rounds // 2:
            use = {}
            for t in cp.placer.tickets.values():
                for v in t.mapping.route[1:-1]:
                    use[v] = use.get(v, 0) + 1
            failed = max(sorted(use), key=use.get)
            out.append(("fail", canon(cp.fail_node(failed))))
        if r == rounds // 2 + 2:
            cp.restore_node(failed)
        cp.check_invariants()
    out.append(("pump", canon(cp.pump(rounds=2))))
    out.append(("flush", canon(cp.flush())))
    cp.check_invariants()
    return cp, out


def plane_phase(T, TS, lc, tk, rg, pool, tag, *, device="cuda", **script):
    """Phase 8 through the kernel, counted, then its plain replay.
    ``device="cpu"`` rehearses it without a card (both runs plain)."""
    launches = {}
    runs = {}
    for impl in (None, "plain"):
        t0 = time.perf_counter()
        tk.LAUNCHES = 0
        tk.LAUNCHES_BY_B.clear()
        with DeviceWaits(lc) as waits:
            cp, out = plane_script(T, TS, rg, pool, impl, device, **script)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[impl] = (cp, out, time.perf_counter() - t0, waits.s)
        launches[impl] = (tk.LAUNCHES, dict(sorted(tk.LAUNCHES_BY_B.items())))
    (cp, out, wall, wait_s), (cpp, outp, wall_p, _) = runs[None], runs["plain"]
    if device == "cuda":
        assert launches[None][0] > 0, "the control plane launched no kernel"
        assert set(cp.placer.stats.kernel_impls) == {"cuda"}
        assert cp.placer.stats.preempted > 0, "the hot spot preempted nothing"
    assert launches["plain"][0] == 0, "the plain replay launched the kernel"
    assert set(cpp.placer.stats.kernel_impls) == {"plain"}
    assert out == outp, "the plain replay returned other outcomes"
    led = cp.conservation()
    assert led == cpp.conservation() and led["ok"] and led["in_flight"] == 0

    def fairness(c):
        rep = c.fairness_report()
        rep.pop("timing")
        return canon(rep)

    assert fairness(cp) == fairness(cpp)
    assert canon(cp.placer.tickets) == canon(cpp.placer.tickets)
    assert np.array_equal(cp.placer.cap, cpp.placer.cap)
    assert np.array_equal(cp.placer.bw, cpp.placer.bw)
    st = cp.placer.stats
    print(f"[{tag}] control plane (centralized, n={rg.n}, micro-batch "
          f"{MICRO_BATCH}, pipeline depth 2, preemption on): "
          f"{len([o for o in out if o[0] == 'rid'])} requests from "
          f"{len(PLANE_TENANTS)} tenants; ledger {led}; admitted "
          f"{st.admitted} rejected {st.rejected} preempted {st.preempted} "
          f"remapped {st.remapped} dropped {st.dropped} defrag "
          f"{st.defrag_rounds}/{st.defrag_commits} stale batches "
          f"{st.stale_batches} cache hits {st.cache_hits}; {st.solves} solves "
          f"taking {st.solve_ms / 1e3:.2f} s, host validate/commit "
          f"{st.overhead_ms / 1e3:.2f} s; kernel launches "
          f"{launches[None][0]} by B {launches[None][1]}; wall {wall:.2f} s, "
          f"host waited on the device {wait_s:.2f} s (host share "
          f"{1 - wait_s / wall:.4f}); plain replay identical (rids, tickets, "
          f"ledger, fairness summary, residuals; wall {wall_p:.2f} s)")
    return launches[None][0], dict(wall_s=wall, wait_s=wait_s)


def build_trace(T, n, assign, block, *, rounds, warmup, base_rate,
                hold_mean=8.0, churn_period=12, churn_down=3, seed=0):
    """``benchmarks/bench_trace.py``'s seeded trace (that module imports the
    JAX package): Pareto-modulated Poisson arrivals on a diurnal sinusoid,
    80/15/5 leaf/block/anywhere endpoints, exponential holds, and
    correlated leaf churn."""
    rng = np.random.default_rng(seed)
    leaves = int(assign.max()) + 1
    k = n // leaves
    events, churn = [], []
    for t in range(rounds):
        diurnal = 1.0 + 0.6 * np.sin(2.0 * np.pi * t / 24.0)
        burst = min(1.0 + float(rng.pareto(2.5)), 8.0)
        for _ in range(int(rng.poisson(base_rate * diurnal * burst))):
            tenant = TRACE_TENANTS[int(rng.integers(len(TRACE_TENANTS)))]
            leaf = int(rng.integers(leaves))
            src = leaf * k + int(rng.integers(k))
            u = float(rng.random())
            if u < 0.80:
                dleaf = leaf
            elif u < 0.95:
                dleaf = (leaf // block) * block + int(rng.integers(block))
            else:
                dleaf = int(rng.integers(leaves))
            dst = dleaf * k + int(rng.integers(k))
            if dst == src:
                dst = dleaf * k + (src - dleaf * k + 1) % k
            p = int(rng.integers(3, 6))
            creq = rng.uniform(0.3, 1.5, size=p).astype(np.float32)
            creq[0] = creq[-1] = 0.0
            breq = rng.uniform(4.0, 18.0, size=p - 1).astype(np.float32)
            events.append({
                "round": t, "tenant": tenant,
                "df": T.DataflowPath(creq, breq, src, dst),
                "hold": max(1, int(rng.exponential(hold_mean))),
                "klass": int(rng.integers(3)),
            })
        if t >= warmup and t % churn_period == 0:
            leaf = int(rng.integers(leaves))
            down = [leaf * k + i for i in range(max(1, k // 4))]
            churn.append((t, "fail", down))
            if t + churn_down < rounds:
                churn.append((t + churn_down, "restore", down))
    return events, churn


def replay(cp, events, churn, *, rounds, warmup):
    """``benchmarks/bench_trace.py``'s replay: per round, churn, submits,
    one pump, admissions noted, expired holds released.  Returns the
    plane's numbers and its final state in comparable form."""
    for t in TRACE_TENANTS:
        cp.register_tenant(t, weight=1.0)
    by_round, churn_by_round = {}, {}
    for ev in events:
        by_round.setdefault(ev["round"], []).append(ev)
    for r, kind, nodes in churn:
        churn_by_round.setdefault(r, []).append((kind, nodes))
    pending, rids = {}, []
    steady_sub = steady_adm = 0
    latencies = []
    for t in range(rounds):
        for kind, nodes in churn_by_round.get(t, []):
            for v in nodes:
                cp.fail_node(v) if kind == "fail" else cp.restore_node(v)
        for ev in by_round.get(t, []):
            rid = cp.submit(ev["tenant"], ev["df"], klass=ev["klass"])
            rids.append(rid)
            pending[rid] = {"sub": t, "expiry": t + ev["hold"], "adm": None}
            steady_sub += t >= warmup
        cp.pump(rounds=1)
        active = set(cp.active_ids())
        for rid, info in pending.items():
            if info["adm"] is None and rid in active:
                info["adm"] = t
                if info["sub"] >= warmup:
                    steady_adm += 1
                    latencies.append(t - info["sub"])
        for rid in [r for r, i in pending.items()
                    if i["expiry"] <= t and r in active]:
            cp.release(rid)
            del pending[rid]
    cp.check_invariants()
    led = cp.conservation()
    cr = cp.coordination_report()
    if "children" in cr:
        msgs = cr["gossip_messages_total"] + cr["twopc_messages_total"]
    else:
        msgs = cr["gossip_messages"] + cr["twopc_messages"]
    reg = cp.metrics_registry()
    lat = np.asarray(latencies, np.float64)
    numbers = {
        "admission_rate": steady_adm / max(steady_sub, 1),
        "steady_submitted": steady_sub,
        "p50_admit_rounds": float(np.percentile(lat, 50)) if lat.size else -1,
        "p99_admit_rounds": float(np.percentile(lat, 99)) if lat.size else -1,
        "max_component_state":
            cp.resident_state_report()["max_component_state"],
        "max_solve_n": cp.solve_size_report()["max_solve_n"],
        "messages_per_round": msgs / rounds,
        "cache_hits": int(reg.total("placer.cache_hits")),
        "dropped": led["dropped"],
        "solves": int(reg.total("placer.solves")),
        "solve_s": reg.total("timing.solve_ms") / 1e3,
        "overhead_s": reg.total("timing.overhead_ms") / 1e3,
    }
    state = canon([rids, cp.active_ids(), led, cr])
    return numbers, state


def trace_phase(T, TS, lc, tk, tag, *, levels=3, branching=4, k=64,
                rounds=TRACE_ROUNDS, warmup=TRACE_WARMUP, device="cuda"):
    """Phase 9: the trace over the flat regional plane and the 2-level
    plane on ``region_tree(levels, branching, k)``, each through the kernel
    (counted) and replayed through the plain version."""
    rg, assign = T.region_tree(levels, branching, k, seed=11)
    events, churn = build_trace(T, rg.n, assign, branching, rounds=rounds,
                                warmup=warmup, base_rate=TRACE_RATE, seed=12)
    planes = (("flat", {}), ("2-level", {"levels": 2, "branching": 8}))
    results, shapes = {}, {}
    for label, kw in planes:
        got = {}
        for impl in (None, "plain"):
            if impl is None:
                tk.LAUNCHES = 0
                tk.LAUNCHES_BY_B.clear()
                tk.LAUNCHES_BY_SHAPE.clear()
            t0 = time.perf_counter()
            with DeviceWaits(lc) as waits:
                cp = TS.ControlPlane(rg, region_of=assign, seed=5,
                                     device=device, **impl_cfg(impl), **kw)
                numbers, state = replay(cp, events, churn, rounds=rounds,
                                        warmup=warmup)
            if device == "cuda":
                torch.cuda.synchronize()
            numbers.update(wall_s=time.perf_counter() - t0, wait_s=waits.s)
            if impl is None:
                numbers.update(launches=tk.LAUNCHES,
                               launches_by_B=dict(sorted(
                                   tk.LAUNCHES_BY_B.items())))
                for shape, c in tk.LAUNCHES_BY_SHAPE.items():
                    shapes[shape] = shapes.get(shape, 0) + c
            got[impl] = (numbers, state)
        (numbers, state), (numbers_p, state_p) = got[None], got["plain"]
        if device == "cuda":
            assert numbers["launches"] > 0, f"{label}: no kernel launched"
        assert state == state_p, f"{label}: the plain replay differs"
        assert numbers["max_solve_n"] <= k
        results[label] = numbers
        print(f"[{tag}] trace replay, {label} plane (n={rg.n}, "
              f"{int(assign.max()) + 1} leaves of {k}, {rounds} rounds, "
              f"{warmup} warm-up, {len(events)} arrivals, {len(churn)} churn "
              f"events): admission rate {numbers['admission_rate']:.4f} of "
              f"{numbers['steady_submitted']}; admit rounds p50 "
              f"{numbers['p50_admit_rounds']} p99 "
              f"{numbers['p99_admit_rounds']}; max_component_state "
              f"{numbers['max_component_state']} max_solve_n "
              f"{numbers['max_solve_n']}; messages per round "
              f"{numbers['messages_per_round']:.2f}; cache hits "
              f"{numbers['cache_hits']}; dropped {numbers['dropped']}; "
              f"{numbers['solves']} solves taking {numbers['solve_s']:.2f} s "
              f"(dispatch + wait + reconstruct), host validate/commit "
              f"{numbers['overhead_s']:.2f} s; "
              f"superstep launches {numbers.get('launches')} by B "
              f"{numbers.get('launches_by_B')}; wall {numbers['wall_s']:.2f} "
              f"s, host waited on the device {numbers['wait_s']:.2f} s (host "
              f"share {1 - numbers['wait_s'] / numbers['wall_s']:.4f}); plain "
              f"replay identical (rids, active set, ledger, coordination "
              f"counts; wall {numbers_p['wall_s']:.2f} s)")
    return results, shapes


# ---------------------------------------------------------------------------
# Phase 10: serving — the mapper as device placement, then the dense model
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2-0.5b"  # the model launch/serve.py's docstring names
SERVE_SLOTS, SERVE_MAX_LEN = 8, 512
SERVE_REQUESTS, SERVE_NEW = 32, 32
PROMPT_LENS = (16, 256)  # uniform, both ends included
SAMPLED, SAMPLE_T, SAMPLE_TOP_K = 8, 0.7, 20  # launch/serve.py's setting
GREEDY_CHECKS = 4  # requests held against a straight-line greedy
HOST_PROMPTS, HOST_PROMPT_LEN, HOST_DECODE = 2, 32, 8


def placement_plans(pl, cfgs, shapes, impl, device):
    """Every plan of the placement path: ``plan_pipeline`` for each arch x
    shape cell x pod count, ``plan_serving`` as ``launch/serve.py`` calls
    it for each arch, and the VLM's tree dataflow."""
    plans = {}
    for pods in (1, 2, 4):
        topo = pl.PodTopology(pods=pods)
        for arch, cfg in cfgs.items():
            for name, shape in shapes.items():
                plans[("pipeline", arch, name, pods)] = pl.plan_pipeline(
                    cfg, shape, topo, device=device, kernel_impl=impl)
    for arch, cfg in cfgs.items():
        plans[("serving", arch)] = pl.plan_serving(
            cfg, shapes["decode_32k"], pl.PodTopology(pods=1),
            requests_per_sec=100.0, device=device, kernel_impl=impl)
    plans[("tree", "internvl2-2b")] = pl.plan_tree_serving(
        cfgs["internvl2-2b"])
    return plans


def plan_key(plan):
    if plan is None:
        return None
    if hasattr(plan, "stage_slices"):
        return (list(plan.stage_slices), tuple(plan.route),
                float(plan.latency_us))
    return (plan.assign, float(plan.cost), plan.valid, plan.routes)


def placement_phase(tk, tag, *, device="cuda"):
    """Placement through the superstep kernel, then through the plain
    version: the same plans, bit for bit.  Returns the kernel's launches."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import placement as pl
    from repro_torch.models.config import SHAPES

    cfgs = {a: get_config(a) for a in ARCHS}
    impl = "cuda" if torch.device(device).type == "cuda" else "plain"
    tk.LAUNCHES = 0
    t0 = time.perf_counter()
    kern = placement_plans(pl, cfgs, SHAPES, impl, device)
    wall = time.perf_counter() - t0
    launches = tk.LAUNCHES
    tk.LAUNCHES = 0
    t0 = time.perf_counter()
    plain = placement_plans(pl, cfgs, SHAPES, "plain", device)
    wall_p = time.perf_counter() - t0
    assert tk.LAUNCHES == 0, "the plain placement launched the kernel"
    for key, plan in kern.items():
        assert plan_key(plan) == plan_key(plain[key]), (key, plan, plain[key])
    if impl == "cuda":
        assert launches > 0, "placement launched no superstep"
    feasible = sum(p is not None for p in kern.values())
    serving = {k[1]: kern[k].stage_slices for k in kern
               if k[0] == "serving" and kern[k] is not None}
    print(f"[{tag}] placement: {len(kern)} plans ({feasible} feasible) "
          f"through the kernel == plain bitwise (stage_slices, route, "
          f"latency_us); {launches} superstep launches; wall {wall:.2f} s "
          f"(plain {wall_p:.2f} s); decode dataflow of launch/serve.py -> "
          f"slices {serving}")
    return launches


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, log, device, key=None):
    """``fn`` with the host clock around each call, synchronized."""
    def run(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        log.append(ms if key is None else (key(*args), ms))
        return out
    return run


def top2_gap(logits):
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def straightline_check(lm, cfg, model, req, device, tag):
    """The engine's greedy tokens against argmax over ``lm_forward`` of the
    whole sequence, step by step, up to the first near tie (top-2 gap at
    most 1e-3 x max |logit|), where cached and recomputed logits may round
    either way."""
    toks = list(req.prompt)
    with torch.no_grad():
        for step, got in enumerate(req.out):
            lg, _ = lm.lm_forward(cfg, model, torch.tensor([toks], device=device),
                                  logits_mode="last")
            row = lg[0, -1]
            gap, scale = top2_gap(row), float(row.abs().max())
            if gap <= 1e-3 * scale:
                print(f"[{tag}] request {req.rid}: near tie at step {step} "
                      f"(top-2 gap {gap:.3g}, max |logit| {scale:.3g}); "
                      f"compared {step} steps")
                return step
            want = int(torch.argmax(row))
            assert got == want, (req.rid, step, got, want, gap)
            toks.append(want)
    return len(req.out)


def greedy_decode(lm, cfg, model, prompts, steps, device, max_len=None,
                  states=None):
    """lm_prefill then greedy lm_decode_step calls at batch len(prompts)
    for ``steps`` tokens, over a cache of ``max_len`` (default: just long
    enough); returns the prefill logits and per-step (tokens, logits).
    ``states``, if given, receives a host copy of every cache leaf right
    after the prefill, by "group.leaf"."""
    B, S = prompts.shape
    cache = lm.init_lm_cache(cfg, B, max_len or S + steps, torch.float32,
                             device=device)
    tok = torch.from_numpy(prompts).to(device)
    first, cache = lm.lm_prefill(cfg, model, tok, cache)
    if states is not None:
        states.update({f"{g}.{k}": t.float().cpu().clone()
                       for g, leaves in cache.items()
                       for k, t in leaves.items()})
    out, logits = [], first[:, -1]
    for i in range(steps):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append((nxt.cpu(), logits.float().cpu()))
        if i + 1 < steps:
            lg, cache = lm.lm_decode_step(cfg, model, nxt[:, None], cache,
                                          S + i)
            logits = lg[:, -1]
    return first[:, -1].float().cpu(), out


def host_check(lm, cfg, model, rng, device, tag, host=None):
    """Prefill logits on the device against the same weights on the host
    CPU (float32; ``host``, or a copy made here), then greedy decoding on
    both."""
    if host is None:
        host = lm.LM(cfg, device="cpu")
        host.load_state_dict(model.state_dict())
    prompts = rng.integers(0, cfg.vocab, (HOST_PROMPTS, HOST_PROMPT_LEN)
                           ).astype(np.int32)
    dev_first, dev_steps = greedy_decode(lm, cfg, model, prompts,
                                         HOST_DECODE, device)
    cpu_first, cpu_steps = greedy_decode(lm, cfg, host, prompts,
                                         HOST_DECODE, "cpu")
    err = float((dev_first - cpu_first).abs().max())
    scale = float(cpu_first.abs().max())
    print(f"[{tag}] prefill logits, {device} vs host CPU (float32, "
          f"{HOST_PROMPTS} prompts of {HOST_PROMPT_LEN}): max abs err "
          f"{err:.3g}, max |logit| {scale:.3g} (limit {1e-3 * scale:.3g})")
    assert err <= 1e-3 * scale, (err, scale)
    compared = []
    for b in range(HOST_PROMPTS):
        n = HOST_DECODE
        for i, ((dt, _), (ct, cl)) in enumerate(zip(dev_steps, cpu_steps)):
            gap = top2_gap(cl[b])
            if gap <= 10 * err:
                print(f"[{tag}] host check, prompt {b}: near tie at decode "
                      f"step {i} (CPU top-2 gap {gap:.3g} <= 10 x {err:.3g});"
                      f" compared {i} steps")
                n = i
                break
            assert int(dt[b]) == int(ct[b]), (b, i, int(dt[b]), int(ct[b]))
        compared.append(n)
    print(f"[{tag}] greedy decode, {device} vs host CPU: tokens agree over "
          f"{compared} of {HOST_DECODE} steps per prompt")
    return err, scale


def draw_model(tag, cfg, device):
    """``cfg``'s model from a generator seeded ``SEED`` on ``device``, and
    its parameter count."""
    from repro_torch.models.registry import init_model

    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=device).manual_seed(SEED),
                       device=device)
    sync(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {cfg.name} float32 on {device}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
          f"({4 * n_params / 1e9:.3f} GB) drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    return model, n_params


def decode_bound_ms(cfg, n_params):
    """The least time of a decode step: the bytes of every weight it reads
    (all but an untied embedding table, of which it gathers a few rows)
    over the HBM rate."""
    table = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    return 1e3 * 4 * (n_params - table) / HBM_BYTES_S


WEIGHT_BYTES = "the bytes of the weights a step reads"


def serve_load(tag, cfg, model, prompts, device, *, max_new, slots, max_len,
               bound, what, watch=None):
    """The engine serves ``prompts`` greedily, timed (tokens/s, decode step
    percentiles against their bound, prefill by 64-token bucket, peak
    memory), then the first ``SAMPLED`` at launch/serve.py's sampling
    setting, twice from one seed, identical; ``watch(model)``, if given, is
    entered around the first sampled run.  ``bound(pos)`` is a decode
    tick's least time in ms from the slots' positions (``what`` names the
    bytes it counts); the stats hold its median over the ticks.  Returns
    the stats and the greedy requests."""
    from repro_torch.serving import Engine, Request

    requests = len(prompts)
    lens = np.array([len(p) for p in prompts])

    def engine(temperature, top_k):
        return Engine(cfg, model, n_slots=slots, max_len=max_len,
                      temperature=temperature, top_k=top_k, seed=SEED,
                      device=device)

    warm = engine(0.0, 0)  # first-call library set-up, not timed
    for i in range(2):
        warm.submit(Request(rid=i, prompt=prompts[i][:16], max_new=4))
    warm.run()
    del warm

    eng = engine(0.0, 0)
    ticks_ms, prefill_ms, bounds = [], [], []
    decode = timed(eng._decode, ticks_ms, device)

    def bounded(*args):
        bounds.append(bound(eng.pos))
        return decode(*args)
    eng._decode = bounded
    eng._prefill = timed(eng._prefill, prefill_ms, device,
                         key=lambda m, t, c: int(t.shape[1]))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    sync(device)
    t0 = time.perf_counter()
    done, ticks = eng.run()
    sync(device)
    wall = time.perf_counter() - t0
    del eng
    assert len(done) == requests and all(len(r.out) == max_new for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)
    generated = sum(len(r.out) for r in done)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    tick = np.asarray(ticks_ms)
    bound_ms = float(np.median(bounds))
    if min(bounds) < max(bounds):
        what = (f"median over the ticks, {min(bounds):.3f}-{max(bounds):.3f}"
                f" ms: {what}")
    by_len = sorted(prefill_ms)
    buckets = {}
    for n, ms in by_len:
        lo = 64 * ((n - 1) // 64) + 1
        buckets.setdefault(f"{lo}-{lo + 63}", []).append(ms)
    stats = {
        "arch": cfg.name, "requests": requests, "slots": slots,
        "max_len": max_len, "max_new": max_new, "wall_s": wall,
        "generated_tokens": generated, "tokens_per_s": generated / wall,
        "ticks": ticks, "decode_steps": len(tick),
        "decode_step_ms_p50": float(np.percentile(tick, 50)),
        "decode_step_ms_p95": float(np.percentile(tick, 95)),
        "decode_bound_ms": bound_ms,
        "prefill_ms_by_len": {k: [len(v), float(np.median(v))]
                              for k, v in buckets.items()},
        "prefill_ms_total": float(sum(ms for _, ms in by_len)),
        "peak_device_bytes": peak,
        "weight_bytes": 4 * sum(p.numel() for p in model.parameters()),
    }
    print(f"[{tag}] engine, greedy: {requests} requests (prompts "
          f"{lens.min()}-{lens.max()} tokens), {slots} slots, max_len "
          f"{max_len}, {max_new} new tokens each: wall {wall:.3f} s, "
          f"{generated} tokens, {stats['tokens_per_s']:.1f} tokens/s, "
          f"{ticks} ticks; decode step p50 {stats['decode_step_ms_p50']:.3f} "
          f"ms p95 {stats['decode_step_ms_p95']:.3f} ms against a bound of "
          f"{bound_ms:.3f} ms ({what} over {HBM_BYTES_S / 1e12} TB/s); "
          f"prefill total "
          f"{stats['prefill_ms_total']:.1f} ms, median ms by prompt length "
          f"[count, ms] {stats['prefill_ms_by_len']}; peak device memory "
          f"{peak}")

    # serve.py's sampling setting, twice from the same seed
    runs = []
    for i in range(2):
        e = engine(SAMPLE_T, SAMPLE_TOP_K)
        for rid, prompt in enumerate(prompts[:SAMPLED]):
            e.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        if watch is not None and i == 0:
            with watch(model):
                out, _ = e.run()
        else:
            out, _ = e.run()
        runs.append([(r.rid, r.out) for r in out])
    assert runs[0] == runs[1], "sampled outputs differ between seeded runs"
    assert all(0 <= t < cfg.vocab for _, o in runs[0] for t in o)
    print(f"[{tag}] engine, temperature {SAMPLE_T} top_k {SAMPLE_TOP_K}: "
          f"{len(runs[0])} requests, two runs from seed {SEED} identical")
    return stats, done


def serve_prompts(cfg, rng, requests, prompt_lens):
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, requests)
    return [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in lens]


def serving_phase(tag, *, device="cuda", arch=SERVE_ARCH, smoke=False,
                  requests=SERVE_REQUESTS, max_new=SERVE_NEW,
                  slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                  prompt_lens=PROMPT_LENS):
    """``launch/serve.py``'s path at full width: the model from a seeded
    generator, the continuous-batching engine (greedy, then the launcher's
    sampling setting twice), and its correctness checks."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as lm

    if torch.device(device).type == "cuda":
        # full-precision float32 products for the comparison with the host
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch, smoke=smoke).with_(dtype="float32")
    model, n_params = draw_model(tag, cfg, device)
    rng = np.random.default_rng(SEED)
    prompts = serve_prompts(cfg, rng, requests, prompt_lens)
    bound_ms = decode_bound_ms(cfg, n_params)
    stats, done = serve_load(tag, cfg, model, prompts, device,
                             max_new=max_new, slots=slots, max_len=max_len,
                             bound=lambda pos: bound_ms, what=WEIGHT_BYTES)

    # (a) the engine against a straight-line greedy
    steps = [straightline_check(lm, cfg, model, r, device, tag)
             for r in sorted(done, key=lambda r: r.rid)[:GREEDY_CHECKS]]
    print(f"[{tag}] engine greedy == straight-line greedy (lm_forward, "
          f"logits_mode='last') over {steps} steps of requests "
          f"0-{GREEDY_CHECKS - 1}")
    stats["straightline_steps"] = steps
    # (b), (c) the device against the host CPU
    err, scale = host_check(lm, cfg, model, rng, device, tag)
    stats["host_max_abs_err"], stats["host_max_logit"] = err, scale
    return stats


# ---------------------------------------------------------------------------
# Phase 11: the MoE family — deepseek-moe-16b at full width and depth
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")  # launcher runs
MOE_ARCH = "deepseek-moe-16b"  # served at full width and depth
MOE_LAYER_ARCH = "phi3.5-moe-42b-a6.6b"  # one full-width layer, check (c)
BOOKKEEPING_CHECKS = 4  # check (a): requests served through one slot
MOE_HOST_DEPTH = 3  # check (b): the dense-first layer and 2 MoE layers
MOE_LAYER_TOKENS = (8, 256)  # check (c)
ROUTE_TIE = 1e-5  # k-th vs (k+1)-th router probability, relative


def launcher_phase(tk, tag, arch):
    """``launch/serve.py --arch arch`` on the card: ``plan_serving``
    through the superstep kernel (its slices equal to the plain version's),
    then the arch's SMOKE engine (or, for whisper, its enc-dec decode).
    Returns the kernel's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import placement as pl
    from repro_torch.launch import serve
    from repro_torch.models.config import SHAPES

    out = io.StringIO()
    tk.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch])
    sync("cuda")
    wall = time.perf_counter() - t0
    launches = tk.LAUNCHES
    assert launches > 0, f"launch/serve.py --arch {arch} launched no superstep"
    lines = out.getvalue().splitlines()
    plain = pl.plan_serving(get_config(arch), SHAPES["decode_32k"],
                            pl.PodTopology(pods=1), requests_per_sec=100.0,
                            device="cuda", kernel_impl="plain")
    assert lines[0] == f"[placement] decode dataflow -> slices " \
        f"{plain.stage_slices}", (lines, plain)
    last = (f"{arch} (enc-dec): decoded 8 steps x 4 streams"
            if get_config(arch).family == "encdec"
            else f"{arch}: served 4 requests")
    assert lines[-1].startswith(last), lines
    print(f"[{tag}] launch/serve.py --arch {arch}: {lines}; {launches} "
          f"superstep launches (slices == kernel_impl='plain'); wall "
          f"{wall:.2f} s")
    return launches


def count_drops(moe_mod, log, slots):
    """A context that counts, on the device, the (token, expert) pairs each
    MoE layer of a model drops while it is entered, split into decode ticks
    (``slots`` tokens) and prefills: a forward pre-hook reruns the port's
    routing on the layer's input."""
    @contextlib.contextmanager
    def watch(model):
        def hook(mod, args):
            x = args[0]
            T = x.shape[0] * x.shape[1]
            r = moe_mod.route(mod.cfg, mod.router, x.reshape(T, -1))
            key = "tick" if T == slots else "prefill"
            log.setdefault(key, []).append((~r.keep).sum())
            log.setdefault(key + "_pairs", []).append(r.keep.numel())

        handles = [b.moe.register_forward_pre_hook(hook)
                   for b in model.blocks]
        try:
            yield
        finally:
            for h in handles:
                h.remove()
    return watch


def route_log(moe_mod, model, log):
    """Hooks recording each MoE call's routing (on the host) into ``log``."""
    def hook(mod, args):
        x = args[0]
        r = moe_mod.route(mod.cfg, mod.router, x.reshape(-1, x.shape[-1]))
        log.append(r._replace(probs=r.probs.cpu(), gate_vals=None,
                              gate_idx=r.gate_idx.cpu(), slot=r.slot.cpu(),
                              keep=r.keep.cpu()))
    return [b.moe.register_forward_pre_hook(hook) for b in model.blocks]


def same_routing(dev, cpu, k, what):
    """Each call's routing on the card equals the CPU's: per token the
    same (expert, slot) pairs (the order of a token's k experts aside),
    except at tokens whose k-th and (k+1)-th CPU router probabilities lie
    within ``ROUTE_TIE`` of each other, relative, which are reported and
    left out; after a near-tied token that did flip, the slots of its two
    experts shift, so only the tokens before it are held to equal slots.
    Returns (tokens compared, near ties, near ties that flipped)."""
    assert len(dev) == len(cpu), (what, len(dev), len(cpu))
    compared = ties = flipped = 0
    for call, (d, c) in enumerate(zip(dev, cpu)):
        T = c.gate_idx.shape[0]
        top = torch.sort(c.probs, dim=-1, descending=True).values
        tie = top[:, k - 1] - top[:, k] <= ROUTE_TIE * top[:, k - 1]
        d_idx, d_ord = torch.sort(d.gate_idx, dim=-1)
        c_idx, c_ord = torch.sort(c.gate_idx, dim=-1)
        d_slot = d.slot.view(T, k).gather(1, d_ord)
        c_slot = c.slot.view(T, k).gather(1, c_ord)
        same = (d_idx == c_idx).all(-1)
        bad = ~same & ~tie
        assert not bad.any(), (what, call, bad.nonzero()[:, 0].tolist())
        upto = T if bool(same.all()) else int((~same).nonzero()[0, 0])
        assert torch.equal(d_slot[:upto], c_slot[:upto]), (what, call, upto)
        if bool(tie.any()):
            print(f"    {what}, call {call}: near-tied tokens "
                  f"{tie.nonzero()[:, 0].tolist()} left out"
                  + (f"; flipped at token {upto}" if upto < T else ""))
        compared += int((~tie).sum())
        ties += int(tie.sum())
        flipped += int((~same).sum())
    return compared, ties, flipped


def batch1_check(lm, cfg, model, done, device, tag, max_len):
    """Each served request's greedy tokens against ``lm_prefill`` +
    ``lm_decode_step`` at batch 1 over a cache of ``max_len``, equal up to
    the first near tie (top-2 gap at most 1e-3 x max |logit|).  Returns
    the steps compared per request."""
    steps = []
    for req in sorted(done, key=lambda r: r.rid):
        _, want = greedy_decode(lm, cfg, model, req.prompt[None],
                                len(req.out), device, max_len=max_len)
        n = len(req.out)
        for i, (got, (tok, logits)) in enumerate(zip(req.out, want)):
            gap, scale = top2_gap(logits[0]), float(logits[0].abs().max())
            if gap <= 1e-3 * scale:
                print(f"[{tag}] request {req.rid}: near tie at step {i} "
                      f"(top-2 gap {gap:.3g}, max |logit| {scale:.3g})")
                n = i
                break
            assert got == int(tok[0]), (req.rid, i, got, int(tok[0]), gap)
        steps.append(n)
    return steps


def bookkeeping_check(lm, cfg, model, prompts, device, tag):
    """(a) A one-slot engine's greedy tokens against ``lm_prefill`` +
    ``lm_decode_step`` at batch 1 over a cache of the same length: both
    route the same T tokens per call, so they drop the same pairs."""
    from repro_torch.serving import Engine, Request

    eng = Engine(cfg, model, n_slots=1, max_len=SERVE_MAX_LEN,
                 temperature=0.0, device=device)
    for i, p in enumerate(prompts[:BOOKKEEPING_CHECKS]):
        eng.submit(Request(rid=i, prompt=p, max_new=SERVE_NEW))
    done, _ = eng.run()
    steps = batch1_check(lm, cfg, model, done, device, tag, SERVE_MAX_LEN)
    print(f"[{tag}] (a) one-slot engine greedy == lm_prefill + "
          f"lm_decode_step at batch 1 over {steps} of {SERVE_NEW} steps of "
          f"requests 0-{BOOKKEEPING_CHECKS - 1}")
    return steps


def moe_serving_phase(tag, *, device="cuda", arch=MOE_ARCH, smoke=False,
                      requests=SERVE_REQUESTS, max_new=SERVE_NEW,
                      slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      prompt_lens=PROMPT_LENS):
    """Phase 10's load on the MoE model at full width and depth, with the
    dropped pairs of the first sampled run counted, then check (a)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as lm

    cfg = get_config(arch, smoke=smoke).with_(dtype="float32")
    model, n_params = draw_model(tag, cfg, device)
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    rng = np.random.default_rng(SEED)
    prompts = serve_prompts(cfg, rng, requests, prompt_lens)
    bound_ms = decode_bound_ms(cfg, n_params)
    active_ms = decode_bound_ms(cfg, cfg.active_param_count())
    drops = {}
    stats, _ = serve_load(
        tag, cfg, model, prompts, device, max_new=max_new, slots=slots,
        max_len=max_len, bound=lambda pos: bound_ms, what=WEIGHT_BYTES,
        watch=count_drops(moe_mod, drops, slots))
    stats["decode_active_bound_ms"] = active_ms
    print(f"[{tag}] decode bound for the active parameters alone "
          f"{active_ms:.3f} ms, what a dispatch reading only the routed "
          f"experts would need (the E x C dispatch runs every expert every "
          f"tick)")
    for key in ("tick", "prefill"):
        got = [int(n) for n in drops.get(key, [])]
        stats[f"dropped_per_{key}"] = [sum(got),
                                       sum(drops.get(key + "_pairs", [])),
                                       len(got)]
    print(f"[{tag}] dropped (token, expert) pairs in the first sampled run "
          f"[dropped, pairs, MoE calls]: decode ticks "
          f"{stats['dropped_per_tick']}, prefills "
          f"{stats['dropped_per_prefill']}")
    stats["bookkeeping_steps"] = bookkeeping_check(lm, cfg, model, prompts,
                                                   device, tag)
    return stats


def moe_host_phase(tag, *, device="cuda", arch=MOE_ARCH, smoke=False,
                   depth=MOE_HOST_DEPTH):
    """(b) The MoE model at full width and depth ``depth`` on the card
    against its copy on the host CPU: prefill logits, greedy decode and
    every MoE call's routing."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as lm

    cfg = get_config(arch, smoke=smoke).with_(dtype="float32",
                                              n_layers=depth)
    model, n_params = draw_model(tag, cfg, device)
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    host = lm.LM(cfg, device="cpu")
    host.load_state_dict(model.state_dict())
    logs = {"dev": [], "cpu": []}
    hooks = (route_log(moe_mod, model, logs["dev"])
             + route_log(moe_mod, host, logs["cpu"]))
    try:
        err, scale = host_check(lm, cfg, model, np.random.default_rng(SEED),
                                device, tag, host=host)
    finally:
        for h in hooks:
            h.remove()
    compared, ties, flipped = same_routing(logs["dev"], logs["cpu"],
                                           cfg.moe.top_k, "(b)")
    print(f"[{tag}] (b) {cfg.name} at depth {depth} ({cfg.param_count()} "
          f"parameters), {device} vs host CPU: routing equal over "
          f"{len(logs['dev'])} MoE calls, {compared} tokens compared, "
          f"{ties} near ties left out ({flipped} flipped)")
    return {"host_max_abs_err": err, "host_max_logit": scale,
            "routing_tokens": compared, "routing_near_ties": ties,
            "routing_flipped": flipped}


def moe_layer_phase(tag, *, device="cuda", arch=MOE_LAYER_ARCH, smoke=False,
                    tokens=MOE_LAYER_TOKENS):
    """(c) One full-width MoE layer of ``arch`` on the card against the
    same weights on the host CPU, on seeded inputs of each token count:
    the output within 1e-3 x max |out| and the routing equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import draw_weights

    cfg = get_config(arch, smoke=smoke).with_(dtype="float32")
    layer = draw_weights(moe_mod.MoE(cfg, device=device),
                         torch.Generator(device=device).manual_seed(SEED))
    n_params = sum(p.numel() for p in layer.parameters())
    host = moe_mod.MoE(cfg, device="cpu")
    host.load_state_dict(layer.state_dict())
    rng = np.random.default_rng(SEED)
    out = {}
    for T in tokens:
        x = rng.normal(0, 1, (1, T, cfg.d_model)).astype(np.float32)
        res = {}
        for dev, mod in ((device, layer), ("cpu", host)):
            xt = torch.from_numpy(x).to(dev)
            with torch.no_grad():
                y, aux = moe_mod.moe_block(cfg, mod, xt)
                r = moe_mod.route(cfg, mod.router, xt[0])
            res[dev] = (y.cpu(), float(aux), r._replace(
                probs=r.probs.cpu(), gate_idx=r.gate_idx.cpu(),
                slot=r.slot.cpu(), keep=r.keep.cpu()))
        (yd, auxd, rd), (yc, auxc, rc) = res[device], res["cpu"]
        err, scale = float((yd - yc).abs().max()), float(yc.abs().max())
        assert err <= 1e-3 * scale, (T, err, scale)
        compared, ties, flipped = same_routing([rd], [rc], cfg.moe.top_k,
                                               f"(c) T={T}")
        dropped = int((~rc.keep).sum())
        print(f"[{tag}] (c) {cfg.name} MoE layer ({n_params} parameters, "
              f"{cfg.moe.n_experts} experts {cfg.d_model} -> "
              f"{cfg.moe.d_ff_expert}, top-{cfg.moe.top_k}) at T={T}: "
              f"{device} vs host CPU max abs err {err:.3g}, max |out| "
              f"{scale:.3g} (limit {1e-3 * scale:.3g}); aux {auxd:.6g} vs "
              f"{auxc:.6g}; routing equal over {compared} tokens, {ties} "
              f"near ties ({flipped} flipped); capacity {rc.capacity}, "
              f"{dropped} of {rc.keep.numel()} pairs dropped")
        out[T] = {"max_abs_err": err, "max_out": scale, "dropped": dropped,
                  "pairs": rc.keep.numel(), "capacity": rc.capacity}
    return out


# ---------------------------------------------------------------------------
# Phase 12: the SSM, hybrid and enc-dec families at full width and depth
# ---------------------------------------------------------------------------

SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")  # served at full width and depth
ENCDEC_ARCH = "whisper-medium"
# Elements of the reference's parameter tree (jax.eval_shape of its
# init_model at the full config).  ModelConfig.param_count() only estimates
# these families: 7,272,140,800, 6,754,562,640 and 758,336,512.
TREE_PARAMS = {"falcon-mamba-7b": 7_272_665_088, "zamba2-7b": 6_751_130_832,
               "whisper-medium": 758_707_200}
# check (b): falcon-mamba cut to 3 layers; zamba2 to 8, one group of 6 and a
# tail of 2, so two call sites of the shared block
SSM_HOST_DEPTH = {"falcon-mamba-7b": 3, "zamba2-7b": 8}
# 4,096 tokens: Mamba-1's scan in 8 chunks of 512, Mamba-2's chunked SSD in
# 16 chunks of 256; 256 tokens: one scan, and Mamba-2's naive recurrence
SSM_HOST_LENS = (256, 4096)
SSM_HOST_DECODE = 16
LONG_PREFILL = 4096  # the full model's long prefill, timed
# The chunked SSD computes inside a chunk in bfloat16 in either config.  A
# float32 sum that lies next to a bfloat16 rounding boundary rounds to
# either side on the card and on the CPU (their sums run in other orders),
# moving that value by one bfloat16 step, 2^-8 relative, and 16 chunks and
# 8 layers carry such steps on.  On the H100 the 8-layer zamba2 cut at
# 4,096 tokens read 8.9e-4 x max on the logits and at most 5.5e-3 x max on
# a cache leaf (attn.k; ssm states 3.8e-3, conv 1.1e-3); the limits keep
# about 2x over those readings, the float32 paths are held to 1e-3.
SSD_LOGITS_TOL = 5e-3
SSD_LEAF_TOL = 1e-2
WHISPER_STREAMS, WHISPER_FRAMES, WHISPER_STEPS = 8, 1500, 128
WHISPER_SELF_LEN = 448  # max_target_len: the decoder's learned positions


def free_device():
    """The last phase's model goes before the next allocates."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() < 2**30, \
            torch.cuda.memory_allocated()


def launch_count(prof) -> int:
    """Kernel launches recorded by a ``torch.profiler`` trace."""
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                            "cuLaunchKernel", "cuLaunchKernelEx"))


def launches_per_call(fn, device, calls=2):
    """Kernel launches per call of ``fn``, traced by ``torch.profiler``
    over ``calls`` calls; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync(device)
    return launch_count(prof) / calls


def ssm_tick_bound(lm, cfg, n_params, max_len):
    """A decode tick's bound in ms from the slots' positions: the bytes of
    every weight but the untied embedding table (a tick gathers a few of
    its rows), each slot's float32 SSM states read and written, and for
    the hybrid the k/v rows 0..pos of every slot that each shared-block
    call site attends to, over the HBM rate."""
    from repro_torch.models import ssm as ssm_mod

    table = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    weights = 4 * (n_params - table)
    slot = ssm_mod.state_init(cfg, 1, torch.float32, device="meta")
    states = 2 * 4 * cfg.n_layers * sum(t.numel() for t in slot.values())
    sites = lm.hybrid_attn_layers(cfg) if cfg.family == "hybrid" else 0
    row = 2 * 4 * cfg.n_kv_heads * cfg.hd()

    def bound(pos):
        pos = np.minimum(np.asarray(pos, np.int64), max_len - 1)
        nbytes = weights + states * len(pos) + sites * row * int(
            (pos + 1).sum())
        return 1e3 * nbytes / HBM_BYTES_S
    return bound


def ssm_serving_phase(tag, arch, *, device="cuda", smoke=False,
                      requests=SERVE_REQUESTS, max_new=SERVE_NEW,
                      slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      prompt_lens=PROMPT_LENS, long_prefill=LONG_PREFILL):
    """Phase 10's load on an SSM or hybrid model at full width and depth
    (float32, drawn from ``SEED``), then (a): the engine's greedy tokens of
    the first ``GREEDY_CHECKS`` requests against ``lm_prefill`` +
    ``lm_decode_step`` at batch 1 (no slot couples to another), a
    ``long_prefill``-token prefill timed, and the launches per tick."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as lm
    from repro_torch.serving import Engine, Request

    cuda = torch.device(device).type == "cuda"
    if cuda:
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = get_config(arch, smoke=smoke).with_(dtype="float32")
    model, n_params = draw_model(tag, cfg, device)
    if not smoke:
        assert n_params == TREE_PARAMS[arch], (n_params, TREE_PARAMS[arch])
    rng = np.random.default_rng(SEED)
    prompts = serve_prompts(cfg, rng, requests, prompt_lens)
    hybrid = cfg.family == "hybrid"
    stats, done = serve_load(
        tag, cfg, model, prompts, device, max_new=max_new, slots=slots,
        max_len=max_len, bound=ssm_tick_bound(lm, cfg, n_params, max_len),
        what=("the bytes of every weight but the untied table, the float32 "
              "states read and written" +
              (" and the k/v rows the shared block attends to"
               if hybrid else "")))
    steps = batch1_check(lm, cfg, model,
                         sorted(done, key=lambda r: r.rid)[:GREEDY_CHECKS],
                         device, tag, max_len)
    print(f"[{tag}] (a) {arch}: engine greedy ({slots} slots) == lm_prefill "
          f"+ lm_decode_step at batch 1 over {steps} of {max_new} steps of "
          f"requests 0-{GREEDY_CHECKS - 1}")
    stats["batch1_steps"] = steps

    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, long_prefill))
                           .astype(np.int32)).to(device)
    cache = lm.init_lm_cache(cfg, 1, long_prefill, torch.float32,
                             device=device)
    sync(device)
    t0 = time.perf_counter()
    logits, cache = lm.lm_prefill(cfg, model, tok, cache)
    sync(device)
    stats["long_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    assert bool(torch.isfinite(logits).all())
    del cache, logits

    eng = Engine(cfg, model, n_slots=slots, max_len=max_len, device=device)
    for i, p in enumerate(prompts[:slots]):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    eng.step()  # fills every slot
    eng.step()
    stats["launches_per_tick"] = launches_per_call(eng.step, device)
    del eng
    stats["peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                  if cuda else None)
    stats["wall_s_phase"] = time.perf_counter() - t_phase
    print(f"[{tag}] {arch}: {long_prefill}-token prefill "
          f"{stats['long_prefill_ms']:.1f} ms; kernel launches per tick "
          f"{stats['launches_per_tick']}; peak device memory "
          f"{stats['peak_device_bytes']}; wall {stats['wall_s_phase']:.2f} s")
    return stats


def ssm_host_phase(tag, arch, *, device="cuda", smoke=False, depth=None,
                   lens=SSM_HOST_LENS, steps=SSM_HOST_DECODE):
    """(b) The model cut to ``depth`` layers at full width on the card
    against its copy on the host CPU, one prompt of each length: prefill
    logits and every cache leaf (conv and ssm states; the hybrid's k/v)
    within the tolerance of the path (1e-3 x max |value|; where the
    chunked SSD runs, ``SSD_LOGITS_TOL`` and ``SSD_LEAF_TOL``), then ``steps`` greedy tokens, equal
    wherever the CPU's top-2 gap exceeds 10x the logits' error."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as lm

    cfg = get_config(arch, smoke=smoke).with_(
        dtype="float32", n_layers=depth or SSM_HOST_DEPTH[arch])
    model, n_params = draw_model(tag, cfg, device)
    host = lm.LM(cfg, device="cpu")
    host.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED)
    out = {}
    for S in lens:
        chunked = (cfg.ssm.version == 2 and S % ssm_mod.SSD_CHUNK == 0
                   and S > ssm_mod.SSD_CHUNK)
        tol, leaf_tol = (SSD_LOGITS_TOL, SSD_LEAF_TOL) if chunked else (
            1e-3, 1e-3)
        prompt = rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)
        res = {}
        for dev, m in ((device, model), ("cpu", host)):
            states = {}
            first, toks = greedy_decode(lm, cfg, m, prompt, steps, dev,
                                        states=states)
            res[dev] = (first[0], states, toks)
        (df, ds, dt), (cf, cs, ct) = res[device], res["cpu"]
        err, scale = float((df - cf).abs().max()), float(cf.abs().max())
        assert err <= tol * scale, (S, err, scale, tol)
        state_err = {}
        for k in cs:
            e, sc = float((ds[k] - cs[k]).abs().max()), float(cs[k].abs().max())
            assert e <= leaf_tol * sc, (S, k, e, sc, leaf_tol)
            state_err[k] = [e, sc]
        n = steps
        for i, ((dtok, _), (ctok, cl)) in enumerate(zip(dt, ct)):
            if top2_gap(cl[0]) <= 10 * err:
                print(f"[{tag}] (b) {arch} S={S}: near tie at decode step "
                      f"{i}; compared {i} steps")
                n = i
                break
            assert int(dtok[0]) == int(ctok[0]), (S, i, int(dtok[0]),
                                                  int(ctok[0]))
        print(f"[{tag}] (b) {cfg.name} at depth {cfg.n_layers} ({n_params} "
              f"parameters), {S}-token prompt, {device} vs host CPU"
              f"{' (chunked SSD, bfloat16 inside a chunk)' if chunked else ''}"
              f": prefill logits max abs err {err:.3g}, max |logit| "
              f"{scale:.3g} (limit {tol:g} x max); cache leaves [err, max] "
              f"{state_err} (limit {leaf_tol:g} x max); greedy tokens "
              f"equal over {n} of {steps} steps")
        out[S] = {"max_abs_err": err, "max_logit": scale, "tol": tol,
                  "leaf_tol": leaf_tol,
                  "states": state_err, "greedy_steps": n}
    return out


def whisper_phase(tag, *, device="cuda", smoke=False,
                  streams=WHISPER_STREAMS, frames=WHISPER_FRAMES,
                  steps=WHISPER_STEPS, self_len=WHISPER_SELF_LEN):
    """whisper-medium at full width and depth in float32: ``streams``
    streams of ``frames`` stub frame embeddings drawn N(0, 0.02) from
    ``SEED``, the encoder and the cross K/V (cross cache of ``frames``),
    then ``steps`` greedy decode steps from token 0 (self cache of
    ``self_len``), timed step by step against each step's bound; stream 0
    held against the host CPU: ``enc_out`` and the first decode logits
    within 1e-3 x max, greedy tokens equal up to a near tie."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ed

    cuda = torch.device(device).type == "cuda"
    if cuda:
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH, smoke=smoke).with_(dtype="float32")
    model, n_params = draw_model(tag, cfg, device)
    if not smoke:
        assert n_params == TREE_PARAMS[ENCDEC_ARCH], n_params
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 0.02, (streams, frames, cfg.d_model)).astype(np.float32))

    def run(m, dev, xs, n_steps):
        """Prefill ms, enc_out, stream 0's (token, logits) per step on the
        host, the ms of each step, and the cache."""
        cache = ed.init_encdec_cache(cfg, xs.shape[0], self_len, xs.shape[1],
                                     torch.float32, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        cache, enc = ed.encdec_prefill(cfg, m, xs.to(dev), cache)
        sync(dev)
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        tok = torch.zeros((xs.shape[0], 1), dtype=torch.int32, device=dev)
        out, ms = [], []
        for pos in range(n_steps):
            t0 = time.perf_counter()
            logits, cache = ed.encdec_decode_step(cfg, m, tok, cache, pos)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            out.append((int(tok[0, 0]), logits[0, -1].float().cpu()))
        return prefill_ms, enc, out, ms, cache

    run(model, device, x[:2, :16], 2)  # first-call library set-up
    prefill_ms, enc, out, ms, cache = run(model, device, x, steps)
    assert bool(torch.isfinite(enc).all())
    assert all(bool(torch.isfinite(lg).all()) for _, lg in out)
    # the bytes a step reads: the decoder's weights but the cross K/V
    # projections (their outputs are cached), the tied head, the cross
    # cache, and the self cache's rows 0..pos
    dec = sum(p.numel() for n, p in model.named_parameters()
              if n.startswith(("dec_blocks", "dec_norm"))
              and not n.endswith(("cross_attn.wk", "cross_attn.wv")))
    row = 2 * 4 * cfg.n_dec_layers * streams * cfg.n_kv_heads * cfg.hd()
    bounds = [1e3 * (4 * (dec + cfg.vocab * cfg.d_model + cfg.d_model)
                     + row * (frames + pos + 1)) / HBM_BYTES_S
              for pos in range(steps)]
    tick = np.asarray(ms)
    pos = steps

    def one_step():
        nonlocal pos
        ed.encdec_decode_step(cfg, model, torch.zeros(
            (streams, 1), dtype=torch.int32, device=device), cache, pos)
        pos += 1
    launches = launches_per_call(one_step, device)
    del cache
    stats = {
        "arch": cfg.name, "streams": streams, "frames": frames,
        "steps": steps, "params": n_params, "prefill_ms": prefill_ms,
        "tokens_per_s": float(streams * steps / (tick.sum() / 1e3)),
        "decode_step_ms_p50": float(np.percentile(tick, 50)),
        "decode_step_ms_p95": float(np.percentile(tick, 95)),
        "decode_bound_ms": float(np.median(bounds)),
        "launches_per_step": launches,
        "peak_device_bytes": (torch.cuda.max_memory_allocated() if cuda
                              else None),
    }
    print(f"[{tag}] {cfg.name} float32: {streams} streams x {frames} frames,"
          f" encoder + cross K/V {prefill_ms:.1f} ms; {steps} greedy decode "
          f"steps: {stats['tokens_per_s']:.1f} tokens/s, step p50 "
          f"{stats['decode_step_ms_p50']:.3f} ms p95 "
          f"{stats['decode_step_ms_p95']:.3f} ms against a bound of "
          f"{stats['decode_bound_ms']:.3f} ms (median over the steps; "
          f"{min(bounds):.3f}-{max(bounds):.3f}: the decoder's weights, the "
          f"tied head, the cross cache and the self cache's rows over "
          f"{HBM_BYTES_S / 1e12} TB/s); kernel launches per step {launches};"
          f" peak device memory {stats['peak_device_bytes']}")

    host = ed.EncDec(cfg, device="cpu")
    host.load_state_dict(model.state_dict())
    _, enc_c, out_c, _, _ = run(host, "cpu", x[:1], steps)
    e_err = float((enc[0].cpu() - enc_c[0]).abs().max())
    e_scale = float(enc_c[0].abs().max())
    err = float((out[0][1] - out_c[0][1]).abs().max())
    scale = float(out_c[0][1].abs().max())
    assert e_err <= 1e-3 * e_scale, (e_err, e_scale)
    assert err <= 1e-3 * scale, (err, scale)
    n = steps
    for i, ((dtok, _), (ctok, cl)) in enumerate(zip(out, out_c)):
        if top2_gap(cl) <= 10 * err:
            print(f"[{tag}] whisper stream 0: near tie at step {i}; compared"
                  f" {i} steps")
            n = i
            break
        assert dtok == ctok, (i, dtok, ctok)
    print(f"[{tag}] whisper stream 0, {device} vs host CPU: enc_out max abs "
          f"err {e_err:.3g} (max {e_scale:.3g}); first decode logits "
          f"{err:.3g} (max |logit| {scale:.3g}); greedy tokens equal over "
          f"{n} of {steps} steps")
    stats.update(enc_max_abs_err=e_err, enc_max=e_scale, host_max_abs_err=err,
                 host_max_logit=scale, greedy_steps=n,
                 wall_s_phase=time.perf_counter() - t_phase)
    return stats


# ---------------------------------------------------------------------------
# Phase 13: training — the launcher, llama3.2-1b at full width and depth,
# a cut against the host CPU, and the int8 error-feedback compression
# ---------------------------------------------------------------------------

# the archs the reference's launcher trains; internvl2-2b and whisper-medium
# fail there (SyntheticLM has no patch_embeds / frames; ROADMAP Queue 3) and
# take one step on make_batch instead, as tests/test_models_smoke.py does
TRAIN_ARCHS = ("qwen2-0.5b", "llama3.2-1b", "qwen2.5-14b", "stablelm-3b",
               "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b",
               "zamba2-7b")
TRAIN_STEP_ARCHS = ("internvl2-2b", "whisper-medium")
TRAIN_ARCH = "llama3.2-1b"  # the model launch/train.py's docstring trains
TRAIN_PARAMS = 1_235_814_400
# published train_4k: 4,096 tokens x 256 sequences; reduced: batch 256 -> 8,
# one sequence per microbatch, 3 steps (the script's time limit)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACC, TRAIN_STEPS = 4096, 8, 8, 3
FAIL_ARCH, FAIL_STEPS, FAIL_AT = "llama3.2-1b", 12, 11  # after the step-10 checkpoint
CUT_LAYERS, CUT_BATCH, CUT_SEQ = 2, 2, 512  # check (c), float32
CUT_LOSS_TOL, CUT_GRAD_TOL, CUT_UPDATE_TOL = 1e-4, 1e-3, 1e-5
BF16_PEAK = 989e12  # dense bf16 FLOP/s, H100 SXM at 700 W (NVIDIA data sheet)


def train_dir(root, name):
    d = root / "build" / "chip_smoke_train" / name
    shutil.rmtree(d, ignore_errors=True)
    return d


def faults(trainer):
    """A trainer's failure and restore events as (kind, step); straggler
    events, which host noise can raise, are left out."""
    return [(e["kind"], e["step"]) for e in trainer.events
            if e["kind"] in ("failure", "restore")]


def train_launcher_phase(tk, tag, root, *, device="cuda"):
    """``launch/train.py --smoke --steps 8`` for every arch the reference's
    launcher trains: the placement line through the superstep kernel equal
    to the plain version's plan, finite losses, no failure; then one run
    with a ``RuntimeError`` injected after its first checkpoint, which must
    fail once, restore once and finish.  Returns the launches per arch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import placement as pl
    from repro_torch.launch import train
    from repro_torch.models.config import ShapeConfig

    shape = ShapeConfig("train", "train", seq_len=64, global_batch=4)
    impl = "cuda" if torch.device(device).type == "cuda" else "plain"

    def launch(arch, steps, inject=None):
        d = train_dir(root, arch)
        out = io.StringIO()
        tk.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            tr = train.main(["--arch", arch, "--smoke", "--steps", str(steps),
                             "--device", device, "--ckpt-dir", str(d)],
                            inject_failure=inject)
        sync(device)
        wall = time.perf_counter() - t0
        launches = tk.LAUNCHES
        shutil.rmtree(d, ignore_errors=True)
        cfg = get_config(arch, smoke=True)
        plans = [pl.plan_pipeline(cfg, shape, pl.PodTopology(pods=1),
                                  steps_per_sec=0.1, device=device,
                                  kernel_impl=k) for k in (impl, "plain")]
        assert plan_key(plans[0]) == plan_key(plans[1]), (arch, plans)
        lines = out.getvalue().splitlines()
        assert lines[0] == (f"[placement] stages->slices "
                            f"{plans[1].stage_slices} "
                            f"(lat {plans[1].latency_us:.1f}us)"), lines
        losses = [m["loss"] for m in tr.metrics_log]
        assert losses and np.isfinite(losses).all(), (arch, losses)
        if impl == "cuda":
            assert launches > 0, f"launch/train.py --arch {arch}: no superstep"
        return tr, lines, launches, wall

    launches = {}
    for arch in TRAIN_ARCHS:
        tr, lines, launches[arch], wall = launch(arch, 8)
        assert tr.restarts == 0 and not faults(tr), (arch, tr.events)
        assert lines[-1].startswith(f"{arch}: 8 steps, loss "), lines
        print(f"[{tag}] launch/train.py --arch {arch} --smoke --steps 8: "
              f"{lines}; {launches[arch]} superstep launches (plan == "
              f"kernel_impl='plain'); step p50 "
              f"{1e3 * np.median([m['step_time_s'] for m in tr.metrics_log]):.2f}"
              f" ms; wall {wall:.2f} s")
    fired = []

    def boom(step):
        if step == FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected failure after the first checkpoint")

    tr, lines, n, wall = launch(FAIL_ARCH, FAIL_STEPS, boom)
    kinds = faults(tr)
    assert kinds == [("failure", FAIL_AT), ("restore", 10)], kinds
    assert tr.restarts == 1 and fired == [FAIL_AT]
    assert lines[-1].startswith(f"{FAIL_ARCH}: {len(tr.metrics_log)} steps")
    print(f"[{tag}] launch/train.py --arch {FAIL_ARCH} --steps {FAIL_STEPS} "
          f"with a RuntimeError injected at step {FAIL_AT}: events {kinds}, "
          f"restarts {tr.restarts}, {len(tr.metrics_log)} steps logged; "
          f"{lines[-1]}; wall {wall:.2f} s")
    return launches


def train_step_phase(tag, *, device="cuda"):
    """One ``build_train_step`` step of the archs the launcher cannot
    train, on ``make_batch``'s inputs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import make_batch
    from repro_torch.optim.adamw import OptConfig

    shape = ShapeConfig("smoke", "train", seq_len=32, global_batch=2)
    for arch in TRAIN_STEP_ARCHS:
        cfg = get_config(arch, smoke=True)
        built = build_train_step(cfg, shape, make_local_mesh(1, 1, device=device),
                                 OptConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=10))
        state = init_train_state(cfg, built)
        losses = []
        for seed in (0, 1):
            state, m = built.fn(state, make_batch(cfg, shape, seed=seed,
                                                  device=device))
            losses.append(float(m["loss"]))
        assert np.isfinite(losses).all() and int(state.step) == 2, losses
        print(f"[{tag}] {arch}: 2 build_train_step steps on make_batch, "
              f"losses {losses}")


def train_flops(cfg, n_params, seq, batch):
    """FLOPs of one step, stated: the forward's matrix products (2 per
    weight per token; the embedding table counts once, as the tied head),
    the causal attention's QK^T and PV over the seq (seq + 1) / 2 pairs a
    sequence needs, the backward at twice the forward, and the forward of
    the blocks again (remat; the head is not recomputed)."""
    tokens = seq * batch
    head = cfg.vocab * cfg.d_model
    blocks = n_params - head - cfg.d_model  # the final norm computes no product
    attn = (cfg.n_layers * batch * 2 * 2 * (seq * (seq + 1) // 2)
            * cfg.n_heads * cfg.hd())
    fwd = 2 * (blocks + head) * tokens + attn
    return 3 * fwd + 2 * blocks * tokens + attn


def llama_train_phase(tag, root, *, device="cuda", smoke=False,
                      steps=TRAIN_STEPS):
    """llama3.2-1b at published width and depth (bfloat16 compute,
    float32 masters) on 8 x 4,096-token batches in 8 microbatches,
    through ``Trainer`` over ``Prefetcher(SyntheticLM)`` as
    ``launch/train.py`` wires them; then its final checkpoint restored
    onto the card bitwise, and check (d), the compression at world size 1
    on the trained model's gradients of one 4,096-token sequence.
    Returns its numbers."""
    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH, smoke=smoke)
    seq, batch, n_acc = (64, 4, 2) if smoke else (TRAIN_SEQ, TRAIN_BATCH,
                                                  TRAIN_ACC)
    shape = ShapeConfig("train_4k", "train", seq_len=seq, global_batch=batch)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    built = build_train_step(cfg, shape, make_local_mesh(1, 1, device=device),
                             OptConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=100),
                             n_acc=n_acc, masked=True)
    state = init_train_state(cfg, built, seed=SEED)
    n_params = sum(t.numel() for t in state.params.values())
    if not smoke:
        assert cfg.dtype == "bfloat16" and n_params == TRAIN_PARAMS, n_params
    data = Prefetcher(iter(SyntheticLM(cfg.vocab, seq, batch, seed=0)))
    d = train_dir(root, "llama_full")
    tr = Trainer(TrainerConfig(ckpt_dir=str(d), ckpt_every=10**9,
                               async_ckpt=False),
                 state, built.fn, data, state_shardings=built.in_shardings[0])
    save_s = []
    orig_save = ckpt_mod.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = orig_save(*a, **kw)
        save_s.append(time.perf_counter() - t0)
        return out

    ckpt_mod.save = timed_save
    t0 = time.perf_counter()
    try:
        tr.run(steps)
    finally:
        ckpt_mod.save = orig_save
    wall = time.perf_counter() - t0
    log = tr.metrics_log
    assert len(log) == steps and tr.restarts == 0 and not faults(tr), \
        tr.events
    for m in log:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), m
        print(f"[{tag}] {TRAIN_ARCH} step {m['step']}: loss {m['loss']:.6f} "
              f"grad_norm {m['grad_norm']:.6f} lr {m['lr']:.3e} step time "
              f"{m['step_time_s']:.3f} s")
    times = [m["step_time_s"] for m in log]
    p50 = float(np.median(times))
    tokens = seq * batch
    flops = train_flops(cfg, n_params, seq, batch)
    bound_s = flops / BF16_PEAK
    peak = torch.cuda.max_memory_allocated() if on_card else None

    # the final checkpoint, restored onto the device bitwise
    t0 = time.perf_counter()
    restored, step = ckpt_mod.restore(str(d), tr.state,
                                      sharding_tree=built.in_shardings[0])
    restore_s = time.perf_counter() - t0
    assert step == steps and int(restored.step) == steps
    n_leaves = 1
    for field in ("params", "m", "v"):
        got, want = getattr(restored, field), getattr(tr.state, field)
        assert list(got) == list(want)
        for k, t in want.items():
            assert got[k].device == t.device and torch.equal(got[k], t), \
                (field, k)
            n_leaves += 1
    ckpt_bytes = sum(f.stat().st_size for f in (d / f"step_{step:08d}").iterdir())
    del restored
    shutil.rmtree(d, ignore_errors=True)

    # check (d): the int8 error-feedback compression at world size 1, on
    # the trained model's gradients of one sequence of the next batch
    one = build_train_step(cfg, ShapeConfig("train_4k", "train", seq_len=seq,
                                            global_batch=1),
                           make_local_mesh(1, 1, device=device), n_acc=1,
                           masked=True)
    loss, grads = one.meta["loss_and_grads"](
        tr.state, {k: v[:1] for k, v in next(data).items()})
    del one
    err = compress.init_error_state(grads)
    out, new_err = compress.compress_all_reduce(
        grads, err, torch.Generator(device=device).manual_seed(SEED))
    worst = 0.0
    for k, g in grads.items():
        g32 = g + err[k]
        scale = torch.clamp_min(g32.abs().max(), 1e-12) * (1.0 / 127.0)
        assert torch.equal(new_err[k], g32 - out[k]), k
        over = float(((out[k] - g32).abs() - scale).max())
        assert over <= 0, (k, over)
        worst = max(worst, float(((out[k] - g32).abs() / scale).max()))
    del grads, err, out, new_err
    stats = dict(
        arch=TRAIN_ARCH, params=n_params, dtype=cfg.dtype, seq=seq,
        batch=batch, n_acc=n_acc, steps=steps,
        losses=[m["loss"] for m in log],
        grad_norms=[m["grad_norm"] for m in log],
        step_s=times, step_p50_s=p50, tokens_per_s=tokens / p50,
        step_flops=flops, bound_s=bound_s, bound_share=bound_s / p50,
        peak_device_bytes=peak, ckpt_save_s=save_s[-1],
        ckpt_restore_s=restore_s, ckpt_bytes=ckpt_bytes,
        ckpt_leaves=n_leaves, wall_s=wall,
        compress_max_err_over_scale=worst, compress_loss=float(loss))
    print(f"[{tag}] {TRAIN_ARCH} training ({n_params} parameters, "
          f"{cfg.dtype} compute, float32 masters; {batch} x {seq} tokens, "
          f"{n_acc} microbatches, remat): step p50 {p50:.3f} s, "
          f"{tokens / p50:.1f} tokens/s; bound {bound_s:.3f} s "
          f"({flops:.4e} FLOPs: 3 x forward + the blocks' recompute, over "
          f"{BF16_PEAK:.3e} bf16 FLOP/s), share {bound_s / p50:.4f}; peak "
          f"device memory {peak}; checkpoint {ckpt_bytes} bytes in "
          f"{n_leaves} leaves saved in {save_s[-1]:.2f} s, restored "
          f"bitwise in {restore_s:.2f} s; compression at world size 1: "
          f"error state == g32 - deq exactly, |deq - g32| <= scale (max "
          f"{worst:.4f} of a scale step); wall {wall:.2f} s")
    return stats


def train_host_phase(tag, *, device="cuda", smoke=False):
    """Check (c): llama3.2-1b cut to 2 layers at full width in float32, 2 x
    512 tokens: loss and gradients on the card against the host CPU from
    the same weights and batch, then one ``apply_updates`` of the CPU's
    gradients on each."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import OptConfig, TrainState, apply_updates

    cfg = get_config(TRAIN_ARCH, smoke=smoke).with_(n_layers=CUT_LAYERS,
                                                    dtype="float32")
    seq, batch = (32, 2) if smoke else (CUT_SEQ, CUT_BATCH)
    shape = ShapeConfig("cut", "train", seq_len=seq, global_batch=batch)
    opt = OptConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    t0 = time.perf_counter()
    built = {dev: build_train_step(cfg, shape, make_local_mesh(1, 1, device=dev),
                                   opt, masked=True)
             for dev in ("cpu", device)}
    card_state = init_train_state(cfg, built[device], seed=SEED)

    def on(dev, tree):
        return {k: t.to(dev, copy=True) for k, t in tree.items()}

    host = TrainState(card_state.step.cpu(), on("cpu", card_state.params),
                      on("cpu", card_state.m), on("cpu", card_state.v))
    b = SyntheticLM(cfg.vocab, seq, batch, seed=1).next_batch()
    l_h, g_h = built["cpu"].meta["loss_and_grads"](host, b)
    l_d, g_d = built[device].meta["loss_and_grads"](card_state, b)
    loss_err = abs(float(l_d) - float(l_h)) / abs(float(l_h))
    assert loss_err <= CUT_LOSS_TOL, (float(l_d), float(l_h))

    def worst(got, want):
        out = 0.0
        for k, w in want.items():
            scale = max(float(w.abs().max()), 1e-30)
            err = float((got[k].cpu() - w).abs().max()) / scale
            out = max(out, err)
        return out

    grad_err = worst(g_d, g_h)
    assert grad_err <= CUT_GRAD_TOL, grad_err
    host, _ = apply_updates(opt, host, g_h)
    card_state, _ = apply_updates(opt, card_state, on(device, g_h))
    upd_err = max(worst(getattr(card_state, f), getattr(host, f))
                  for f in ("params", "m", "v"))
    assert upd_err <= CUT_UPDATE_TOL, upd_err
    n = sum(t.numel() for t in host.params.values())
    print(f"[{tag}] {TRAIN_ARCH} cut to {CUT_LAYERS} layers at full width "
          f"({n} parameters, float32), {batch} x {seq} tokens, card vs host "
          f"CPU: loss {float(l_d):.6f} vs {float(l_h):.6f} (rel err "
          f"{loss_err:.3e}, limit {CUT_LOSS_TOL}); gradients max err "
          f"{grad_err:.3e} x max |CPU leaf| (limit {CUT_GRAD_TOL}); one "
          f"apply_updates max err {upd_err:.3e} x max (limit "
          f"{CUT_UPDATE_TOL}); wall {time.perf_counter() - t0:.2f} s")
    return dict(loss_rel_err=loss_err, grad_err=grad_err, update_err=upd_err)


# -- phase 14: the mesh path (DeviceMesh + DTensor) at world size 1 ---------

# train_4k with the published TRAIN_MODE "seq" and TRAIN_ACC 2; reduced:
# global batch 256 -> 4
SHARD_SEQ, SHARD_BATCH, SHARD_STEPS = 4096, 4, 2
SHARD_LEAF_TOL = 1e-5  # a leaf that is not bitwise, x max |one-device leaf|
# prefill_32k, reduced: batch 32 -> 2; decode_32k, reduced: batch 128 -> 16
PREFILL_SEQ, PREFILL_BATCH = 32768, 2
DECODE_SEQ, DECODE_BATCH, DECODE_STEPS, DECODE_FROM = 32768, 16, 32, 32000
SERVE_CUT_LAYERS, SERVE_CUT_SEQ, SERVE_CUT_TOL = 2, 512, 1e-3


@contextlib.contextmanager
def world_of_one(device):
    """A process group of one rank on a free local port: NCCL on a card,
    gloo on the CPU; destroyed at the end."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_mesh(device):
    """``make_local_mesh(1, 1)`` inside the group: a DeviceMesh."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 1, device=device)
    assert isinstance(mesh, DeviceMesh), type(mesh)
    return mesh


def whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def leaf_diffs(got: dict, want: dict):
    """(leaves not bitwise equal, the worst |got - want| / max |want|)."""
    differ, worst = [], 0.0
    for k, w in want.items():
        g = whole(got[k])
        if not torch.equal(g, w):
            differ.append(k)
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((g.float() - w.float()).abs().max())
                        / scale)
    return differ, worst


def sharded_train_phase(tag, *, device="cuda", smoke=False):
    """(a) llama3.2-1b at published width and depth (bfloat16 compute,
    float32 masters), train_4k's sequence in the published sequence-
    parallel mode with 2 microbatches, 2 steps through ``build_train_step``
    on the DeviceMesh and the same 2 steps, from the same state and
    batches, through the one-device path: losses and every master, m and v
    leaf bitwise (a leaf that is not is named, within SHARD_LEAF_TOL)."""
    from repro_torch.configs import get_config, train_accumulation, train_mode
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (build_train_step, init_train_state,
                                          shard_state)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import OptConfig, TrainState

    cfg = get_config(TRAIN_ARCH, smoke=smoke)
    seq, batch = (64, 4) if smoke else (SHARD_SEQ, SHARD_BATCH)
    mode, n_acc = train_mode(TRAIN_ARCH), train_accumulation(TRAIN_ARCH)
    shape = ShapeConfig("train_4k", "train", seq_len=seq, global_batch=batch)
    opt = OptConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    dev = torch.device(device)
    t0 = time.perf_counter()
    one = build_train_step(cfg, shape, Mesh(dev), opt, n_acc=n_acc,
                           masked=True, mode=mode)
    state1 = init_train_state(cfg, one, seed=SEED)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=0)
    batches = [data.next_batch() for _ in range(SHARD_STEPS)]
    with world_of_one(device):
        mesh = local_mesh(device)
        built = build_train_step(cfg, shape, mesh, opt, n_acc=n_acc,
                                 masked=True, mode=mode)
        assert built.meta["n_acc"] == one.meta["n_acc"] == n_acc
        state2 = shard_state(TrainState(state1.step.clone(), *(
            {k: t.clone() for k, t in getattr(state1, f).items()}
            for f in ("params", "m", "v"))), built.in_shardings[0])
        times = {"one_device": [], "mesh": []}
        losses = {"one_device": [], "mesh": []}
        for b in batches:
            for key, fn in (("one_device", one.fn), ("mesh", built.fn)):
                sync(device)
                t = time.perf_counter()
                if key == "one_device":
                    state1, m = fn(state1, b)
                else:
                    state2, m = fn(state2, b)
                sync(device)
                times[key].append(time.perf_counter() - t)
                losses[key].append(float(m["loss"]))
        differ, worst = [], 0.0
        for f in ("params", "m", "v"):
            d, w = leaf_diffs(getattr(state2, f), getattr(state1, f))
            differ += [f"{f}/{k}" for k in d]
            worst = max(worst, w)
        step_equal = int(whole(state2.step)) == int(state1.step)
        n_leaves = 3 * len(state1.params)
        del state2, built
    assert step_equal
    assert losses["mesh"] == losses["one_device"], losses
    assert worst <= SHARD_LEAF_TOL, (differ[:8], worst)
    n_params = sum(t.numel() for t in state1.params.values())
    del state1, one
    out = dict(arch=TRAIN_ARCH, params=n_params, dtype=cfg.dtype, seq=seq,
               batch=batch, n_acc=n_acc, mode=mode, losses=losses,
               step_s=times, leaves=n_leaves, leaves_not_bitwise=differ,
               worst_leaf_err=worst, wall_s=time.perf_counter() - t0)
    print(f"[{tag}] phase 14 (a) {TRAIN_ARCH} ({n_params} parameters, "
          f"{cfg.dtype} compute, mode {mode}, {batch} x {seq} tokens in "
          f"{n_acc} microbatches) on make_local_mesh(1, 1), a DeviceMesh, "
          f"against the one-device step: losses {losses['mesh']} == "
          f"{losses['one_device']}; {n_leaves - len(differ)} of {n_leaves} "
          f"state leaves bitwise (others {differ[:8]}, worst "
          f"{worst:.3e} x max); step s mesh {times['mesh']} one-device "
          f"{times['one_device']}; wall {out['wall_s']:.2f} s")
    return out


def decode_step_bound_ms(cfg, n_params, batch, pos):
    """The least time of one bfloat16 decode step: the weights read once
    (the tied table once, as the head) and each layer's k/v rows up to
    ``pos`` read once, over the HBM rate."""
    rows = cfg.n_layers * 2 * batch * (pos + 1) * cfg.n_kv_heads * cfg.hd()
    return 1e3 * 2 * (n_params + rows) / HBM_BYTES_S


def sharded_serve_phase(tag, *, device="cuda", smoke=False):
    """(b) llama3.2-1b at published width and depth in bfloat16 through
    ``build_prefill_step`` (prefill_32k's sequence) and
    ``build_decode_step`` (a decode_32k cache, DECODE_STEPS steps from
    DECODE_FROM) on the DeviceMesh, each output and the cache it leaves
    bitwise equal to a direct ``lm_prefill`` / ``lm_decode_step`` on the
    same weights and inputs as plain tensors; then a SERVE_CUT_LAYERS-layer
    float32 cut through both builders, card against the host CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import init_model

    cfg = get_config(TRAIN_ARCH, smoke=smoke)
    on_card = torch.device(device).type == "cuda"
    if smoke:
        pseq, pbatch, dseq, dbatch, dsteps, dfrom = 64, 2, 64, 4, 4, 40
    else:
        pseq, pbatch = PREFILL_SEQ, PREFILL_BATCH
        dseq, dbatch, dsteps, dfrom = (DECODE_SEQ, DECODE_BATCH, DECODE_STEPS,
                                       DECODE_FROM)
    rng = np.random.default_rng(SEED)
    t_phase = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=device).manual_seed(SEED),
                       device=device)
    n_params = sum(p.numel() for p in model.parameters())
    out = dict(arch=TRAIN_ARCH, params=n_params, dtype=cfg.dtype)
    with world_of_one(device):
        mesh = local_mesh(device)
        pre = steps.build_prefill_step(
            cfg, ShapeConfig("prefill_32k", "prefill", pseq, pbatch), mesh)
        dec = steps.build_decode_step(
            cfg, ShapeConfig("decode_32k", "decode", dseq, dbatch), mesh)
        sharded = lm.LM(cfg, device="meta")
        sharded.load_state_dict(model.state_dict(), assign=True)
        steps.shard_model(sharded, pre.in_shardings[0])

        # prefill: the builder on DTensors against the direct call
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (pbatch, pseq)).astype(np.int32)).to(device)
        cache = steps.init_cache(pre)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync(device)
        t = time.perf_counter()
        logits, cache = pre.fn(sharded, cache, {"tokens": tokens})
        sync(device)
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t)
        plain = lm.init_lm_cache(cfg, pbatch, pseq, torch.bfloat16
                                 if cfg.dtype == "bfloat16" else torch.float32,
                                 device=device)
        sync(device)
        t = time.perf_counter()
        want, plain = lm.lm_prefill(cfg, model, tokens, plain)
        sync(device)
        out["prefill_direct_ms"] = 1e3 * (time.perf_counter() - t)
        assert torch.equal(whole(logits), want), "prefill logits"
        for name in ("k", "v"):
            assert torch.equal(whole(cache["attn"][name]),
                               plain["attn"][name]), f"prefill cache {name}"
        del cache, plain, logits, want

        # decode over a filled decode_32k cache
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        cache = steps.init_cache(dec)
        plain = {}
        for name, t_ in cache["attn"].items():
            fill = torch.randn(t_.shape, generator=gen, device=device,
                               dtype=t_.dtype).mul_(0.5)
            t_.to_local().copy_(fill)  # one rank: its shard is the whole
            plain[name] = fill
        plain = {"attn": plain}
        toks = [torch.from_numpy(rng.integers(
            0, cfg.vocab, (dbatch, 1)).astype(np.int32)).to(device)
            for _ in range(dsteps)]
        step_ms, direct_ms = [], []
        for i, tok in enumerate(toks):
            pos = dfrom + i
            sync(device)
            t = time.perf_counter()
            logits, cache = dec.fn(sharded, cache, tok, pos)
            sync(device)
            step_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            want, plain = lm.lm_decode_step(cfg, model, tok, plain, pos)
            sync(device)
            direct_ms.append(1e3 * (time.perf_counter() - t))
            assert torch.equal(whole(logits), want), f"decode step {i}"
        for name in ("k", "v"):
            assert torch.equal(whole(cache["attn"][name]),
                               plain["attn"][name]), f"decode cache {name}"
        out["peak_device_bytes"] = (torch.cuda.max_memory_allocated()
                                    if on_card else None)
        del cache, plain, sharded
    bound = decode_step_bound_ms(cfg, n_params, dbatch, dfrom + dsteps - 1)
    out.update(prefill_tokens=pbatch * pseq, decode_batch=dbatch,
               decode_cache=dseq, decode_from=dfrom, decode_steps=dsteps,
               decode_ms_p50=float(np.percentile(step_ms, 50)),
               decode_ms_p95=float(np.percentile(step_ms, 95)),
               decode_direct_ms_p50=float(np.percentile(direct_ms, 50)),
               decode_bound_ms=bound)
    del model
    print(f"[{tag}] phase 14 (b) {TRAIN_ARCH} ({n_params} parameters, "
          f"{cfg.dtype}) builders on the DeviceMesh == direct calls, "
          f"bitwise: prefill {pbatch} x {pseq} tokens {out['prefill_ms']:.1f}"
          f" ms (direct {out['prefill_direct_ms']:.1f} ms); decode batch "
          f"{dbatch} over a {dseq}-position cache, {dsteps} steps from "
          f"{dfrom}: p50 {out['decode_ms_p50']:.3f} ms p95 "
          f"{out['decode_ms_p95']:.3f} ms (direct p50 "
          f"{out['decode_direct_ms_p50']:.3f} ms), bound {bound:.3f} ms "
          f"(bf16 weights + the k/v rows read, over {HBM_BYTES_S:.3g} B/s); "
          f"peak device memory {out['peak_device_bytes']}")

    # the float32 cut at full width: both builders, card against the CPU
    cut = cfg.with_(n_layers=SERVE_CUT_LAYERS, dtype="float32")
    cseq = 32 if smoke else SERVE_CUT_SEQ
    cmodel = init_model(cut, torch.Generator(device=device).manual_seed(SEED),
                        device=device)
    host = lm.LM(cut, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in cmodel.state_dict().items()})
    ptoks = torch.from_numpy(rng.integers(0, cut.vocab, (2, cseq))
                             .astype(np.int32))
    dtoks = [torch.from_numpy(rng.integers(0, cut.vocab, (2, 1))
                              .astype(np.int32)) for _ in range(4)]

    def serve(model_, mesh_, dev):
        p = steps.build_prefill_step(
            cut, ShapeConfig("cut", "prefill", cseq, 2), mesh_)
        d = steps.build_decode_step(
            cut, ShapeConfig("cut", "decode", cseq, 2), mesh_)
        steps.shard_model(model_, p.in_shardings[0])
        c = steps.init_cache(p)
        lg, c = p.fn(model_, c, {"tokens": ptoks.to(dev)})
        res = [whole(lg).cpu()]
        for i, tk in enumerate(dtoks):
            lg, c = d.fn(model_, c, tk.to(dev), cseq - 4 + i)
            res.append(whole(lg).cpu())
        return res

    with world_of_one(device):
        got = serve(cmodel, local_mesh(device), device)
    want = serve(host, Mesh(torch.device("cpu")), "cpu")
    errs = []
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        errs.append(float((g - w).abs().max()) / scale)
    assert max(errs) <= SERVE_CUT_TOL, errs
    out["cut_errs"] = errs
    out["wall_s"] = time.perf_counter() - t_phase
    del cmodel, host
    print(f"[{tag}] phase 14 (b) {TRAIN_ARCH} cut to {SERVE_CUT_LAYERS} "
          f"layers in float32, prefill 2 x {cseq} then 4 decode steps through "
          f"the builders, card vs host CPU: logits max err "
          f"{max(errs):.3e} x max (limit {SERVE_CUT_TOL}); phase wall "
          f"{out['wall_s']:.2f} s")
    return out


# -- phase 15: the cost model and the dry runs -------------------------------

DRYRUN_CELL = ("qwen2-0.5b", "decode_32k")
TRAIN_DRYRUN_CELL = ("llama3.2-1b", "train_4k")  # phase 15 (c)
TRAIN_DRYRUN_TIMEOUT_S = 600  # from its start in phase 15
# (c)'s per-device FLOPs on the single-pod mesh (256 ranks), to the 7
# digits the CPU sweep reads: the attention runs each rank's own q heads
# (2 of 32), and so does the gradient of ``wo``; every weight gradient,
# the tied LM head's included, runs on the rank's own share
TRAIN_DRYRUN_FLOPS = "4.823678e+13"
DRYRUN_MESHES = ("single", "multi")
# phase 15 (d): the serving prefill at published widths, 2 layers, on the
# single-pod mesh; its dense products' FLOPs per device, to the 7 digits
# of the CPU count: 2 layers x 2 x 65,536 tokens x 60,817,408 weights /
# 16, and the LM head over the rank's last tokens
PREFILL_DRYRUN_CELL = ("llama3.2-1b", "prefill_32k")
PREFILL_DRYRUN_LAYERS = 2
PREFILL_DRYRUN_MM_FLOPS = "9.964981e+11"
# phase 15 (e): a Mamba-1 decode at published widths, 2 layers, on the
# single-pod mesh; its FLOPs per device, to the 7 digits of the CPU
# count: 8 tokens x (2 layers x 13,156,352 + the LM head's 33,292,288),
# each a sixteenth of the one-rank count
SSM_DRYRUN_CELL = ("falcon-mamba-7b", "decode_32k")
SSM_DRYRUN_LAYERS = 2
SSM_DRYRUN_FLOPS = "4.768399e+08"
# phase 15 (f): the Mamba-1 train step at published widths and the
# production shape, 2 layers, on the single-pod mesh: the embedding's
# rows and their gradient on local tensors (torch 2.11's DTensor
# ``aten.index_put`` rejects split indices); its FLOPs per device, to the
# 7 digits of the CPU count (every weight gradient on the rank's share)
SSM_TRAIN_DRYRUN_CELL = ("falcon-mamba-7b", "train_4k")
SSM_TRAIN_DRYRUN_LAYERS = 2
SSM_TRAIN_DRYRUN_FLOPS = "1.289349e+13"
# phase 15 (g): the hybrid's decode at published widths, 2 layers (one
# call site of the shared block, its 32 kv heads split over the model
# axis of 16), on the single-pod mesh: the decode attention on local
# shards (torch 2.11 rejects the DTensor einsum there); its FLOPs per
# device, to the 7 digits of the CPU count
HYBRID_DRYRUN_CELL = ("zamba2-7b", "decode_32k")
HYBRID_DRYRUN_LAYERS = 2
HYBRID_DRYRUN_FLOPS = "7.256310e+08"
# phase 15 (h): the MoE train step at published widths and the production
# shape, 2 layers (one dense, one MoE), on the single-pod mesh: each rank
# routes its own tokens and runs its own 4 experts on its data rank's 960
# of the 15,360 capacity slots (the expert products on local blocks,
# outside DTensor's choice of layout); its FLOPs per device, to the 7
# digits of the CPU count
MOE_TRAIN_DRYRUN_CELL = ("deepseek-moe-16b", "train_4k")
MOE_TRAIN_DRYRUN_LAYERS = 2
MOE_TRAIN_DRYRUN_FLOPS = "1.193249e+13"
# phase 15 (i): the VLM's sequence-parallel train step at published widths
# and the production shape, 2 layers, on the single-pod mesh: its head
# over 92,553 columns, which the model axis does not divide, runs on
# each rank's own 256 of the 4,096 sequence rows, and the loss on them
# (the image rows masked in place); its FLOPs per device, to the 7 digits
# of the CPU count
VLM_TRAIN_DRYRUN_CELL = ("internvl2-2b", "train_4k")
VLM_TRAIN_DRYRUN_LAYERS = 2
VLM_TRAIN_DRYRUN_FLOPS = "1.001846e+13"
# phase 15 (j): qwen2-0.5b's sequence-parallel train step at published
# widths and the production shape, 2 layers, on the single-pod mesh: its
# q reaches the attention replicated on the model axis (14 heads over
# 16 ways) and each rank runs its own q head, the gradient of the slice a
# Partial share; its FLOPs per device, to the 7 digits of the CPU count
# (1.483415e13 with q whole on every rank)
QWEN_TRAIN_DRYRUN_CELL = ("qwen2-0.5b", "train_4k")
QWEN_TRAIN_DRYRUN_LAYERS = 2
QWEN_TRAIN_DRYRUN_FLOPS = "5.007261e+12"
FP32_FLOPS_S = 2 * LANE_OPS_S  # one FMA per FP32 lane per cycle: 6.69e13
COST_SLOTS, COST_MAX_LEN = 8, 512  # phase 10's engine
_CHILDREN: list = []  # the dry runs' subprocesses, stopped at exit


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


atexit.register(_stop, _CHILDREN)


def start_dryruns(root, cell, sub, *, device="cuda", scale=16,
                  meshes=DRYRUN_MESHES, n_layers=None):
    """``launch/dryrun.py`` for ``cell`` on the single- and multi-pod
    meshes (``meshes``) at edge ``scale`` (256 and 512 fake ranks at 16),
    with ``--device`` ``device`` and again with ``--device cpu``, each in
    its own subprocess, all started now; fake tensors, nothing allocated.
    ``n_layers`` cuts the model's depth.  Returns the running cells for
    ``collect_dryruns``."""
    out = root / "build" / "chip_smoke_dryrun" / sub
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    arch, shape = cell
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               REPRO_DRYRUN_SCALE=str(scale), OMP_NUM_THREADS="1")
    cut = [] if n_layers is None else ["--n-layers", str(n_layers)]
    procs = {}
    for mesh in meshes:
        for dev in dict.fromkeys((device, "cpu")):
            log = out / f"{mesh}_{dev}.log"
            with open(log, "w") as f:
                procs[mesh, dev] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--device", dev, "--save-hlo", "--out", str(out / dev)]
                    + cut,
                    env=env, cwd=root, stdout=f, stderr=subprocess.STDOUT)
            _CHILDREN.append(procs[mesh, dev])
    return dict(cell=cell, out=out, device=device, scale=scale, procs=procs,
                meshes=meshes, t0=time.perf_counter())


def collect_dryruns(tag, label, run, *, timeout):
    """Wait for the cells of ``start_dryruns`` and check them.  The counts
    are shape counts: the two devices' FLOPs, collectives and argument
    bytes must be equal; an operator that moves other bytes on one device
    (it decomposes differently there) is printed.  A failed cell raises
    (the others are stopped)."""
    (arch, shape), out, device = run["cell"], run["out"], run["device"]
    scale = run["scale"]
    cells = {}
    try:
        for (mesh, dev), p in run["procs"].items():
            left = max(1.0, timeout - (time.perf_counter() - run["t0"]))
            p.wait(timeout=left)
            if p.returncode:
                log = (out / f"{mesh}_{dev}.log").read_text()
                raise RuntimeError(f"dry run {arch} x {shape} x {mesh} on "
                                   f"{dev} failed:\n{log[-3000:]}")
            stem = f"{arch}__{shape}__{mesh}"
            cells[mesh, dev] = json.loads((out / dev / f"{stem}.json")
                                          .read_text())
            cells[mesh, dev]["ops"] = json.loads(
                (out / dev / f"{stem}.ops.json").read_text())
    finally:
        _stop(run["procs"].values())
    wall = time.perf_counter() - run["t0"]
    stats = {}
    for mesh in run["meshes"]:
        rec = cells[mesh, device]
        la = rec["loop_aware"]
        kinds = {k: int(v["count"]) for k, v in la["collectives"].items()}
        assert rec["chips"] == scale * scale * (2 if mesh == "multi" else 1)
        twin = cells[mesh, "cpu"]
        differ = {k: (rec["ops"].get(k), twin["ops"].get(k))
                  for k in set(rec["ops"]) | set(twin["ops"])
                  if rec["ops"].get(k) != twin["ops"].get(k)}
        if differ:
            print(f"[{tag}] phase 15 {label} {mesh}: operators counted "
                  f"differently on fake {device} and fake CPU tensors "
                  f"({device}, cpu): {differ}")
        if rec["collectives"] != twin["collectives"]:
            print(f"[{tag}] phase 15 {label} {mesh}: the largest "
                  f"collectives on fake {device} tensors "
                  f"{rec['collectives']['top_ops']}; on fake CPU tensors "
                  f"{twin['collectives']['top_ops']}")
        for key in ("flops", "collectives"):
            assert la[key] == twin["loop_aware"][key], (
                mesh, key, la[key], twin["loop_aware"][key])
        assert rec["memory"]["argument_bytes"] == \
            twin["memory"]["argument_bytes"]
        stats[mesh] = dict(chips=rec["chips"], flops=la["flops"],
                           mm_flops=rec["ops"].get("aten.mm", {}).get(
                               "flops", 0.0),
                           bytes_hbm=la["bytes_hbm"], collectives=kinds,
                           collective_bytes=la["collective_bytes_total"],
                           argument_bytes=rec["memory"]["argument_bytes"],
                           temp_bytes=rec["memory"]["temp_bytes"],
                           peak_bytes=rec["memory"]["peak_bytes"],
                           n_acc=rec["n_acc"], mode=rec["mode"],
                           warnings=la["warnings"],
                           lower_s=rec["timing"]["lower_s"],
                           compile_s=rec["timing"]["compile_s"])
        print(f"[{tag}] phase 15 {label} dry run {arch} x {shape} x {mesh}: "
              f"chips {rec['chips']}, n_acc {rec['n_acc']}, mode "
              f"{rec['mode']}, per-device FLOPs {la['flops']:.6e}, "
              f"bytes_hbm {la['bytes_hbm']:.6e}, collectives {kinds} "
              f"({la['collective_bytes_total']:.6e} B), argument_bytes "
              f"{rec['memory']['argument_bytes']}, temp_bytes "
              f"{rec['memory']['temp_bytes']}, peak_bytes "
              f"{rec['memory']['peak_bytes']} (fake {device} tensors; fake "
              f"CPU: bytes_hbm {twin['loop_aware']['bytes_hbm']:.6e}, temp "
              f"{twin['memory']['temp_bytes']}); build "
              f"{rec['timing']['lower_s']:.2f}"
              f" s, counted run {rec['timing']['compile_s']:.2f} s")
    stats["wall_s"] = wall
    return stats


def dryrun_cells(tag, root, *, device="cuda", scale=16):
    """(a) ``launch/dryrun.py`` for DRYRUN_CELL on both meshes
    (``start_dryruns``), checked by ``collect_dryruns``."""
    run = start_dryruns(root, DRYRUN_CELL, "decode", device=device,
                        scale=scale)
    return collect_dryruns(tag, "(a)", run, timeout=600)


def decode_cost(cfg, model, device, slots, max_len):
    """The cost model over one warm ``lm_decode_step`` of an engine of
    ``slots`` x ``max_len`` (per-slot positions), on ``model``'s tensors."""
    from repro_torch.launch import hlo_cost
    from repro_torch.models import transformer as lm

    cache = lm.init_lm_cache(cfg, slots, max_len, torch.float32,
                             device=device)
    token = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    pos = torch.arange(slots, dtype=torch.int32, device=device) * 7 + 3
    with torch.no_grad():
        lm.lm_decode_step(cfg, model, token, cache, pos)  # warm
        with hlo_cost.Counters() as c:
            c.arguments(model, cache, token, pos)
            c.outputs(lm.lm_decode_step(cfg, model, token, cache, pos))
    return c


def cost_model_phase(tag, serving_p50, *, device="cuda", smoke=False,
                     slots=COST_SLOTS, max_len=COST_MAX_LEN):
    """(b) the cost model on the card with real tensors: one warm
    ``lm_decode_step`` of phase 10's qwen2-0.5b float32 engine shape,
    its FLOPs and HBM bytes (and every operator's) equal to the same count
    on fake CPU tensors of the same shapes; its bound, the larger of the
    FLOPs over the float32 rate outside the tensor cores and the bytes
    over the HBM rate, beside phase 10's measured p50 and the weights'
    bytes bound."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models.registry import empty_model

    cfg = get_config(SERVE_ARCH, smoke=smoke).with_(dtype="float32")
    model, n_params = draw_model(tag, cfg, device)
    card = decode_cost(cfg, model, device, slots, max_len)
    del model
    with FakeTensorMode():
        fake = decode_cost(cfg, empty_model(cfg, "cpu"), "cpu", slots,
                           max_len)
    differ = sorted(k for k in set(card.by_op) | set(fake.by_op)
                    if card.by_op.get(k) != fake.by_op.get(k))
    if differ:
        print(f"[{tag}] phase 15 (b) operators counted differently on "
              f"{device} and on fake CPU tensors: "
              + "; ".join(f"{k}: {card.by_op.get(k)} vs {fake.by_op.get(k)}"
                          for k in differ))
    assert (card.flops, card.bytes_hbm) == (fake.flops, fake.bytes_hbm), (
        (card.flops, card.bytes_hbm), (fake.flops, fake.bytes_hbm), differ)
    flops_ms = 1e3 * card.flops / FP32_FLOPS_S
    bytes_ms = 1e3 * card.bytes_hbm / HBM_BYTES_S
    bound_ms = max(flops_ms, bytes_ms)
    weights_ms = decode_bound_ms(cfg, n_params)
    mem = card.memory()
    print(f"[{tag}] phase 15 (b) cost model, one warm lm_decode_step of "
          f"{SERVE_ARCH} float32 ({slots} slots, max_len {max_len}) on "
          f"{device}: FLOPs {card.flops:.6e}, bytes_hbm {card.bytes_hbm:.6e}"
          f", {int(card.n_ops)} operators, equal to the fake CPU count "
          f"(host-to-device copies apart: {card.transfer_bytes:.0f} B on "
          f"{device}, {fake.transfer_bytes:.0f} B on the CPU); "
          f"bound max({flops_ms:.4f} ms at {FP32_FLOPS_S:.4g} FLOP/s "
          f"float32, {bytes_ms:.4f} ms at {HBM_BYTES_S:.4g} B/s) = "
          f"{bound_ms:.4f} ms against phase 10's decode step p50 "
          f"{serving_p50} ms and the weights' bytes bound {weights_ms:.4f} "
          f"ms; memory {mem}")
    return dict(flops=card.flops, bytes_hbm=card.bytes_hbm,
                operators=int(card.n_ops),
                transfer_bytes=card.transfer_bytes, flops_ms=flops_ms,
                bytes_ms=bytes_ms, bound_ms=bound_ms,
                weights_bound_ms=weights_ms, serving_p50_ms=serving_p50,
                memory=mem)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root / "tests"))  # the kernels' seeded test cases
    import repro_torch.core as T
    from repro_torch.core import leastcost as lc
    from repro_torch.core.graph import validate_mapping
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels.minplus import batched as tk
    from repro_torch.kernels.minplus import minplus as tm
    from repro_torch.kernels.place import place as tp

    tag = card()
    print(tag)
    cur_mhz, max_mhz = sm_clock_mhz()
    print(f"[{tag}] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; SM clock {cur_mhz:.0f} MHz "
          f"(max {max_mhz:.0f} MHz)")

    # -- phase 1: build every kernel, one nvcc per source, in parallel ----
    t0 = time.perf_counter()
    builds = _build.build_all([tk.SOURCE, tm.SOURCE, tp.SOURCE,
                               root / "src/repro_torch/kernels/csrc/empty.cu"])
    wall = time.perf_counter() - t0
    for b in builds:
        usage = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[{tag}] kernel build {b.source.name}: nvcc {b.build_s:.2f} s, "
              f"cache hit {b.cache_hit}, {b.path.name}"
              + "".join(f"\n    {u}" for u in usage))
    for mod in (tk, tm, tp):
        mod.load_library()
    print(f"[{tag}] all kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc wall {wall:.2f} s)")

    # -- phase 2: kernel == plain, bitwise --------------------------------
    check_kernel(tk, tag)
    step_t = {B: time_kernel(tk, tag, B, N_NODES, P + 1, 10 + B)
              for B in (1, MICRO_BATCH)}
    main_t = step_t[MICRO_BATCH]
    for B in (1, 8):
        time_kernel(tk, tag, B, 4096, P + 1, 12 + B)
    check_minplus(tm, tag)
    check_place(tp, tag)
    floor_ms = empty_floor(root, tag)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    K = P + 1
    mm_t = time_minplus(tm, tag, N_NODES, N_NODES, K, 31, floor_ms, flush)
    mm_more = [time_minplus(tm, tag, N_NODES, N_NODES // D, K, 31 + D,
                            floor_ms) for D in (2, 4)]
    mm_more.append(time_minplus(tm, tag, 4096, 4096, K, 32, floor_ms, flush))
    del flush
    pw_t = time_place(tp, tag, N_NODES, K, 33, floor_ms)
    pw_more = [time_place(tp, tag, n, k, 34 + k, floor_ms)
               for n, k in ((4096, K), (2**20, K), (2**20, 33))]

    # -- phase 3: the main path at real size -------------------------------
    rg = T.waxman(N_NODES, seed=SEED)
    stream = make_stream(T, rg)
    fallbacks = [0, 0.0]
    inner_python = lc.leastcost_python

    def counted_python(*a, **k):
        t0 = time.perf_counter()
        fallbacks[0] += 1
        try:
            return inner_python(*a, **k)
        finally:
            fallbacks[1] += time.perf_counter() - t0

    lc.leastcost_python = counted_python
    check_dispatch_async(T, rg, stream, tag)
    placer = make_placer(T, rg, None)
    tk.LAUNCHES = 0
    tk.LAUNCHES_BY_B.clear()
    fallbacks[:] = [0, 0.0]
    out, run = drive(placer, stream, lc)
    launches = tk.LAUNCHES
    by_b = dict(sorted(tk.LAUNCHES_BY_B.items()))
    fb_main = list(fallbacks)
    placer.check_invariants()
    for t in placer.tickets.values():
        ok, why = validate_mapping(rg, t.df, t.mapping)
        assert ok, f"ticket {t.tid}: {why}"
    st = placer.stats
    assert launches > 0, "main path launched no kernel"
    assert set(st.kernel_impls) == {"cuda"}, st.kernel_impls
    assert st.supersteps.get("cold") and st.supersteps.get("warm"), \
        f"need cold and warm solves: {st.supersteps}"
    assert st.admitted > 0

    def mean_rounds(mode):
        h = st.supersteps[mode]
        return sum(r * c for r, c in h.items()) / sum(h.values())

    cm = np.asarray(run["commit_ms"])
    print(f"[{tag}] main path: n={rg.n} edges={rg.num_edges} arrivals="
          f"{ARRIVALS} batches of {MICRO_BATCH}, pipeline depth 2; admitted "
          f"{st.admitted} rejected {st.rejected} released {st.released} "
          f"remapped {st.remapped} dropped {st.dropped} conflicts "
          f"{st.batch_conflicts} stale_batches {st.stale_batches}; cache hits "
          f"{st.cache_hits} stale {st.cache_stale} neg {st.cache_neg_hits} "
          f"warm_solves {st.warm_solves} warm_fallbacks {st.warm_fallbacks}; "
          f"failed node {run['failed_node']}")
    # each solve of r rounds enqueues min(max_rounds, CHUNK*ceil(r/CHUNK))
    expect = sum(c * min(lim, lc.CHUNK * -(-r // lc.CHUNK))
                 for mode, lim in (("cold", rg.n - 1),
                                   ("warm", placer.max_correction_supersteps))
                 for r, c in st.supersteps[mode].items())
    print(f"[{tag}] kernel launches (supersteps) on the main path: {launches} "
          f"({expect} by the rounds of the solves that finished; the rest "
          f"were enqueued by batches the epoch fence discarded); "
          f"solves {st.solves}; supersteps per cold solve "
          f"{mean_rounds('cold'):.2f} {dict(sorted(st.supersteps['cold'].items()))}; "
          f"per warm solve {mean_rounds('warm'):.2f} "
          f"{dict(sorted(st.supersteps['warm'].items()))}")
    assert sum(by_b.values()) == launches, (by_b, launches)
    for B in by_b:
        if B not in step_t:
            step_t[B] = time_kernel(tk, tag, B, N_NODES, P + 1, 10 + B)
    print(f"[{tag}] main path supersteps by batch B: {by_b}; kernel device ms"
          f" at each B (n={N_NODES}, K={P + 1}): "
          + ", ".join(f"B={B}: {step_t[B]['ms']:.4f}" for B in by_b)
          + "; device ms the main path spent in the kernel "
          f"{sum(c * step_t[B]['ms'] for B, c in by_b.items()):.2f}")
    print(f"[{tag}] admissions per second {st.admitted / run['wall_s']:.2f} "
          f"(wall {run['wall_s']:.2f} s); commit_admit p50 "
          f"{np.percentile(cm, 50):.2f} ms p95 {np.percentile(cm, 95):.2f} ms "
          f"over {len(cm)} commits; host share of wall time "
          f"{1 - run['wait_s'] / run['wall_s']:.4f} (device waits "
          f"{run['wait_s']:.2f} s); reconstruct fallbacks {fb_main[0]} "
          f"taking {fb_main[1]:.2f} s")
    print(f"[{tag}] wall split: solve {st.solve_ms / 1e3:.2f} s (dispatch + "
          f"wait + reconstruct), host validate/commit {st.overhead_ms / 1e3:.2f}"
          f" s, conflict re-solves {st.conflict_resolve_ms / 1e3:.2f} s")

    # -- phase 4: the same script through the plain version -----------------
    placer_p = make_placer(T, rg, "plain")
    tk.LAUNCHES = 0
    out_p, run_p = drive(placer_p, stream, lc)
    assert tk.LAUNCHES == 0, "the plain rerun launched the kernel"
    assert set(placer_p.stats.kernel_impls) == {"plain"}
    assert [t and t.tid for t in out] == [t and t.tid for t in out_p]
    for a, b in zip(out, out_p):
        if a is not None:
            assert a.mapping == b.mapping, (a.tid, a.mapping, b.mapping)
    assert sorted(placer.tickets) == sorted(placer_p.tickets)
    assert np.array_equal(placer.cap, placer_p.cap)
    assert np.array_equal(placer.bw, placer_p.bw)
    dev, dev_p = placer.res.device_tensors(), placer_p.res.device_tensors()
    for k in ("cap", "bw", "lat"):
        assert torch.equal(dev[k], dev_p[k]), k
    print(f"[{tag}] plain rerun identical: {len(out)} outcomes, "
          f"{len(placer.tickets)} live tickets, residual arrays bitwise equal "
          f"(plain wall {run_p['wall_s']:.2f} s)")

    # -- phase 5: the decentralized engine through the move kernel -------
    dfs = distinct_requests(stream, ENGINE_REQUESTS)
    t0 = time.perf_counter()
    kern = engine_phase(T, tm, rg, dfs, tag, fallbacks)
    mm_launches = kern["launches"]
    superstep_split(lc, dist_mod, tm, rg, dfs[0], tag)
    print(f"[{tag}] engine phase wall {time.perf_counter() - t0:.2f} s")

    # -- phase 6: the place_window op through its kernel -----------------
    pw_launches = place_op_phase(tp, rg, dfs, tag)

    # -- phase 7: every backend on the paper's worked example ------------
    paper_phase(T, tag)

    # -- phase 8: the centralized control plane --------------------------
    import repro_torch.service as TS

    pool = distinct_requests(stream, POOL)
    plane_launches, _ = plane_phase(T, TS, lc, tk, rg, pool, tag)

    # -- phase 9: the regional and hierarchical planes on the trace ------
    trace, shapes = trace_phase(T, TS, lc, tk, tag)
    region_t = {}
    for B in sorted({b for b, _, _ in shapes}):
        (_, n, K), count = max(((s, c) for s, c in shapes.items()
                                if s[0] == B), key=lambda sc: sc[1])
        region_t[B] = dict(time_kernel(tk, tag, B, n, K, 20 + B), n=n, K=K,
                           launches=sum(c for s, c in shapes.items()
                                        if s[0] == B))
    print(f"[{tag}] phase 9 supersteps by (B, n, K): "
          f"{dict(sorted(shapes.items()))}; kernel device ms at each B "
          f"(most launched n, K): "
          + ", ".join(f"B={B} (n={t['n']}, K={t['K']}): {t['ms']:.4f} "
                      f"(bound {t['bound_ms']:.3g}, {t['bound_by']})"
                      for B, t in region_t.items()))

    # -- phase 10: serving: placement through the kernel, then the model --
    t0 = time.perf_counter()
    placement_launches = placement_phase(tk, tag)
    serving = serving_phase(tag)
    print(f"[{tag}] serving: {json.dumps(serving)}")
    print(f"[{tag}] phase 10 wall {time.perf_counter() - t0:.2f} s")

    # -- phase 11: the MoE family -----------------------------------------
    # phase 10's model and engines went with serving_phase's frame
    free_device()
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launcher_launches = {a: launcher_phase(tk, tag, a) for a in MOE_ARCHS}
    moe = moe_serving_phase(tag)
    total = torch.cuda.get_device_properties(0).total_memory
    assert moe["peak_device_bytes"] < total, (moe["peak_device_bytes"], total)
    for check in (moe_host_phase, moe_layer_phase):
        free_device()
        moe["host" if check is moe_host_phase else "layer"] = check(tag)
    moe["launcher_launches"] = launcher_launches
    print(f"[{tag}] moe serving: {json.dumps(moe)}")
    print(f"[{tag}] phase 11 wall {time.perf_counter() - t0:.2f} s; peak "
          f"device memory {moe['peak_device_bytes']} of {total}; script "
          f"wall so far {time.perf_counter() - t_script:.2f} s")

    # -- phase 12: the SSM, hybrid and enc-dec families --------------------
    free_device()
    t0 = time.perf_counter()
    for arch in SSM_ARCHS + (ENCDEC_ARCH,):
        launcher_launches[arch] = launcher_phase(tk, tag, arch)
    families = {}
    for arch in SSM_ARCHS:
        families[arch] = {}
        for check in (ssm_serving_phase, ssm_host_phase):
            free_device()
            families[arch][check.__name__] = check(tag, arch)
    free_device()
    families[ENCDEC_ARCH] = whisper_phase(tag)
    print(f"[{tag}] ssm, hybrid and enc-dec serving: {json.dumps(families)}")
    print(f"[{tag}] phase 12 wall {time.perf_counter() - t0:.2f} s; script "
          f"wall so far {time.perf_counter() - t_script:.2f} s")

    # -- phase 13: training -------------------------------------------------
    free_device()
    t0 = time.perf_counter()
    train_launches = train_launcher_phase(tk, tag, root)
    train_step_phase(tag)
    free_device()
    training = {"host_cut": train_host_phase(tag)}
    free_device()
    training["full"] = llama_train_phase(tag, root)
    free_device()
    print(f"[{tag}] training: {json.dumps(training)}")
    print(f"[{tag}] phase 13 wall {time.perf_counter() - t0:.2f} s; script "
          f"wall so far {time.perf_counter() - t_script:.2f} s")

    # -- phase 14: the mesh path (DeviceMesh + DTensor) ----------------------
    t0 = time.perf_counter()
    mesh_path = {"train": sharded_train_phase(tag)}
    free_device()
    mesh_path["serve"] = sharded_serve_phase(tag)
    free_device()
    print(f"[{tag}] mesh path: {json.dumps(mesh_path)}")
    print(f"[{tag}] phase 14 wall {time.perf_counter() - t0:.2f} s; script "
          f"wall so far {time.perf_counter() - t_script:.2f} s")

    # -- phase 15: the cost model and the dry runs ---------------------------
    t0 = time.perf_counter()
    # (c)'s train cells run on the host beside (a) and (b), after phase
    # 14's host-clock timings
    train_dryrun = start_dryruns(root, TRAIN_DRYRUN_CELL, "train")
    # (d)'s prefill cells and (e)'s Mamba decode cells beside them
    prefill_dryrun = start_dryruns(root, PREFILL_DRYRUN_CELL, "prefill",
                                   meshes=("single",),
                                   n_layers=PREFILL_DRYRUN_LAYERS)
    ssm_dryrun = start_dryruns(root, SSM_DRYRUN_CELL, "ssm",
                               meshes=("single",), n_layers=SSM_DRYRUN_LAYERS)
    # (f)'s Mamba train cells and (g)'s hybrid decode cells: the two paths
    # torch 2.11's DTensor rejected
    ssm_train_dryrun = start_dryruns(root, SSM_TRAIN_DRYRUN_CELL, "ssm_train",
                                     meshes=("single",),
                                     n_layers=SSM_TRAIN_DRYRUN_LAYERS)
    hybrid_dryrun = start_dryruns(root, HYBRID_DRYRUN_CELL, "hybrid",
                                  meshes=("single",),
                                  n_layers=HYBRID_DRYRUN_LAYERS)
    # (h)'s MoE train cells: each rank on its own experts and slots
    moe_train_dryrun = start_dryruns(root, MOE_TRAIN_DRYRUN_CELL, "moe_train",
                                     meshes=("single",),
                                     n_layers=MOE_TRAIN_DRYRUN_LAYERS)
    # (i)'s VLM train cells: the head and the loss on each rank's own rows
    vlm_train_dryrun = start_dryruns(root, VLM_TRAIN_DRYRUN_CELL, "vlm_train",
                                     meshes=("single",),
                                     n_layers=VLM_TRAIN_DRYRUN_LAYERS)
    # (j)'s qwen2-0.5b train cells: a replicated q on each rank's own heads
    qwen_train_dryrun = start_dryruns(root, QWEN_TRAIN_DRYRUN_CELL,
                                      "qwen_train", meshes=("single",),
                                      n_layers=QWEN_TRAIN_DRYRUN_LAYERS)
    cost = {"dryrun": dryrun_cells(tag, root)}
    cost["decode_step"] = cost_model_phase(
        tag, serving["decode_step_ms_p50"])
    free_device()
    cost["train_dryrun"] = collect_dryruns(tag, "(c)", train_dryrun,
                                           timeout=TRAIN_DRYRUN_TIMEOUT_S)
    flops = cost["train_dryrun"]["single"]["flops"]
    assert f"{flops:.6e}" == TRAIN_DRYRUN_FLOPS, (flops, TRAIN_DRYRUN_FLOPS)
    print(f"[{tag}] phase 15 (c) {TRAIN_DRYRUN_CELL[0]} x "
          f"{TRAIN_DRYRUN_CELL[1]} single: {flops:.6e} FLOPs per device == "
          f"{TRAIN_DRYRUN_FLOPS}")
    cost["prefill_dryrun"] = collect_dryruns(tag, "(d)", prefill_dryrun,
                                             timeout=TRAIN_DRYRUN_TIMEOUT_S)
    mm = cost["prefill_dryrun"]["single"]["mm_flops"]
    assert f"{mm:.6e}" == PREFILL_DRYRUN_MM_FLOPS, (mm,
                                                    PREFILL_DRYRUN_MM_FLOPS)
    print(f"[{tag}] phase 15 (d) {PREFILL_DRYRUN_CELL[0]} cut to "
          f"{PREFILL_DRYRUN_LAYERS} layers x {PREFILL_DRYRUN_CELL[1]} single:"
          f" aten.mm {mm:.6e} FLOPs per device == {PREFILL_DRYRUN_MM_FLOPS} "
          f"(all operators {cost['prefill_dryrun']['single']['flops']:.6e})")
    cost["ssm_dryrun"] = collect_dryruns(tag, "(e)", ssm_dryrun,
                                         timeout=TRAIN_DRYRUN_TIMEOUT_S)
    flops = cost["ssm_dryrun"]["single"]["flops"]
    assert f"{flops:.6e}" == SSM_DRYRUN_FLOPS, (flops, SSM_DRYRUN_FLOPS)
    print(f"[{tag}] phase 15 (e) {SSM_DRYRUN_CELL[0]} cut to "
          f"{SSM_DRYRUN_LAYERS} layers x {SSM_DRYRUN_CELL[1]} single: "
          f"{flops:.6e} FLOPs per device == {SSM_DRYRUN_FLOPS}")
    for key, label, run, cell, layers, want in (
            ("ssm_train_dryrun", "(f)", ssm_train_dryrun,
             SSM_TRAIN_DRYRUN_CELL, SSM_TRAIN_DRYRUN_LAYERS,
             SSM_TRAIN_DRYRUN_FLOPS),
            ("hybrid_dryrun", "(g)", hybrid_dryrun, HYBRID_DRYRUN_CELL,
             HYBRID_DRYRUN_LAYERS, HYBRID_DRYRUN_FLOPS),
            ("moe_train_dryrun", "(h)", moe_train_dryrun,
             MOE_TRAIN_DRYRUN_CELL, MOE_TRAIN_DRYRUN_LAYERS,
             MOE_TRAIN_DRYRUN_FLOPS),
            ("vlm_train_dryrun", "(i)", vlm_train_dryrun,
             VLM_TRAIN_DRYRUN_CELL, VLM_TRAIN_DRYRUN_LAYERS,
             VLM_TRAIN_DRYRUN_FLOPS),
            ("qwen_train_dryrun", "(j)", qwen_train_dryrun,
             QWEN_TRAIN_DRYRUN_CELL, QWEN_TRAIN_DRYRUN_LAYERS,
             QWEN_TRAIN_DRYRUN_FLOPS)):
        cost[key] = collect_dryruns(tag, label, run,
                                    timeout=TRAIN_DRYRUN_TIMEOUT_S)
        flops = cost[key]["single"]["flops"]
        assert f"{flops:.6e}" == want, (label, flops, want)
        print(f"[{tag}] phase 15 {label} {cell[0]} cut to {layers} layers x "
              f"{cell[1]} single: {flops:.6e} FLOPs per device == {want}")
    print(f"[{tag}] cost model: {json.dumps(cost)}")
    print(f"[{tag}] phase 15 wall {time.perf_counter() - t0:.2f} s; script "
          f"wall so far {time.perf_counter() - t_script:.2f} s")

    print(json.dumps({"kernels": [{
        "name": "batched_superstep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/batched_superstep.cu",
        "replaces": "src/repro/kernels/minplus/batched.py:85",
        "launches": launches,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "at_B": MICRO_BATCH,
        "launches_by_B": by_b,
        "launches_by_path": {
            "admission": launches, "control_plane": plane_launches,
            **{f"trace_{label}": r["launches"] for label, r in trace.items()},
            "placement": placement_launches,
            **{f"serve_launcher_{a}": n for a, n in launcher_launches.items()},
            **{f"train_launcher_{a}": n for a, n in train_launches.items()},
        },
        "region_local": {B: {k: t[k] for k in (
            "n", "K", "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")} for B, t in region_t.items()},
        "B1": {k: step_t[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "max_abs_err")},
    }, {
        "name": "masked_minplus",
        "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/masked_minplus.cu",
        "replaces": "src/repro/kernels/minplus/minplus.py:45",
        "launches": mm_launches,
        "max_abs_err": mm_t["max_abs_err"],
        "ms": mm_t["ms"],
        "plain_ms": mm_t["plain_ms"],
        "bound_ms": mm_t["bound_ms"],
        "bound_by": mm_t["bound_by"],
        "library_ms": None,
        "cold_ms": mm_t["cold_ms"],
        "empty_kernel_ms": floor_ms,
        "other_shapes": mm_more,
    }, {
        "name": "place_window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/place/csrc/place_window.cu",
        "replaces": "src/repro/kernels/place/place.py:35",
        "launches": pw_launches,
        "max_abs_err": pw_t["max_abs_err"],
        "ms": pw_t["ms"],
        "plain_ms": pw_t["plain_ms"],
        "bound_ms": pw_t["bound_ms"],
        "bound_by": pw_t["bound_by"],
        "library_ms": None,
        "empty_kernel_ms": floor_ms,
        "other_shapes": pw_more,
    }]}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
