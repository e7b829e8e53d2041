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
  1024-node Waxman network with a 512-arrival stream (the batched superstep
  kernel; its supersteps are also counted by batch size B), replayed with
  ``kernel_impl="plain"``, which must end in the bitwise-same state;
- the decentralized BSP engine ``solve(method="shard_map")`` on one rank
  over 32 distinct requests of that stream (the masked min-plus kernel),
  against its plain rerun and ``leastcost_torch``;
- the op ``place_window`` (the capacity-window place kernel) on the same
  requests' capacity windows;

and finally runs every registered backend on the paper's worked example.
Any failure raises and exits nonzero.  Without a CUDA device it exits
nonzero before printing any result.

Output: timings and counts, each tagged with the card's name and power
limit; then one JSON line of per-kernel numbers; then the card's name and
power limit; and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import json
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
ARRIVALS = 512
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
          f"{bound_ms:.4f} ms ({candidates:.3e} candidates x "
          f"{OPS_PER_CANDIDATE} ops over {ops_s:.3e} lane-ops/s = "
          f"{bound_ops_ms:.4f} ms; bytes bound {bound_bytes_ms:.4f} ms); "
          f"kernel / bound {ms / bound_ms:.2f}x; SM clock under this kernel "
          f"{loaded_mhz:.0f} MHz, operations bound at that clock "
          f"{at_clock_ms:.4f} ms")
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
    commit_ms, out, waits = [], [], [0.0]
    inner_commit = placer.commit_admit

    def timed_commit(pending):
        t0 = time.perf_counter()
        r = inner_commit(pending)
        commit_ms.append(1e3 * (time.perf_counter() - t0))
        return r

    placer.commit_admit = timed_commit
    inner_finish = lc_module._Relaxation.finish

    def timed_finish(self):
        t0 = time.perf_counter()
        r = inner_finish(self)
        waits[0] += time.perf_counter() - t0
        return r

    lc_module._Relaxation.finish = timed_finish
    failed = None
    batches = [stream[i:i + MICRO_BATCH]
               for i in range(0, len(stream), MICRO_BATCH)]
    t0 = time.perf_counter()
    try:
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
    finally:
        lc_module._Relaxation.finish = inner_finish
    wall = time.perf_counter() - t0
    return out, dict(wall_s=wall, commit_ms=commit_ms,
                             wait_s=waits[0], failed_node=failed)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
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
