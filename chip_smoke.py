"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA superstep kernel from ``src/repro_torch`` (``nvcc``, at first
use, into ``build/repro_torch/``), holds it bit for bit against its plain
PyTorch version on the card, then drives the port's main path — online
admission through ``OnlinePlacer`` + ``AdmissionPipeline`` — on a
1024-node Waxman network with a 512-arrival stream, checks the result, and
replays the same seeded stream with ``kernel_impl="plain"``, which must end
in the bitwise-same state.  Any failure raises and exits nonzero.  Without a
CUDA device it exits nonzero before printing any result.

Output: timings and counts, each tagged with the card's name and power
limit; then one JSON line of per-kernel numbers; then the card's name and
power limit; and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
OPS_PER_CANDIDATE = 4  # add, clamp, bandwidth compare, running-min select


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


def random_state(B, n, K, seed, big_frac=0.4, BIG=np.float32(1e18)):
    """Random superstep inputs shaped like the reference kernel test's."""
    rng = np.random.default_rng(seed)
    C = np.where(rng.random((B, n, K)) < big_frac, BIG,
                 rng.random((B, n, K)) * 10).astype(np.float32)
    pv = rng.integers(-1, n, size=(B, n, K)).astype(np.int32)
    pj = rng.integers(-1, K, size=(B, n, K)).astype(np.int32)
    lat = np.where(rng.random((n, n)) < 0.5, BIG,
                   rng.random((n, n)) * 5 + 0.1).astype(np.float32)
    np.fill_diagonal(lat, BIG)
    bw = (rng.random((n, n)) * 100).astype(np.float32)
    cap = (rng.random(n) * 6).astype(np.float32)
    prefix = np.concatenate(
        [np.zeros((B, 1), np.float32),
         np.cumsum(rng.random((B, K - 1)).astype(np.float32) * 2, axis=1)],
        axis=1).astype(np.float32)
    breq_k = np.concatenate(
        [np.full((B, 1), BIG, np.float32),
         (rng.random((B, K - 2)) * 60).astype(np.float32),
         np.full((B, 1), BIG, np.float32)], axis=1)
    return [C, pv, pj, lat, bw, cap, prefix, breq_k]


def tie_state(B=2, n=16, K=4, BIG=np.float32(1e18)):
    C = np.full((B, n, K), BIG, np.float32)
    C[:, :2, 1:3] = 0.0
    pv = np.full((B, n, K), -1, np.int32)
    lat = np.full((n, n), 1.0, np.float32)
    np.fill_diagonal(lat, BIG)
    bw = np.full((n, n), 100.0, np.float32)
    cap = np.full((n,), 50.0, np.float32)
    prefix = np.tile(np.arange(K, dtype=np.float32)[None, :], (B, 1)) * np.float32(0.1)
    breq_k = np.concatenate([np.full((B, 1), BIG, np.float32),
                             np.full((B, K - 2), 1.0, np.float32),
                             np.full((B, 1), BIG, np.float32)], axis=1)
    return [C, pv, pv.copy(), lat, bw, cap, prefix, breq_k]


def check_kernel(tk, tag):
    """Phase 2: the kernel against the plain version, bitwise."""
    cases = [
        ("random", random_state(3, 12, 6, 0)),
        ("random", random_state(4, 40, 7, 1)),
        ("ties", tie_state()),
        ("big_overflow", random_state(2, 10, 5, 9, big_frac=1.0)),
        ("ragged_n", random_state(5, 45, 9, 2)),
        ("ragged_n", random_state(3, 1000, 5, 3)),
        ("B1_K2", random_state(1, 33, 2, 4)),
        ("main_shape", random_state(64, N_NODES, P + 1, 5)),
        ("n4096", random_state(8, 4096, P + 1, 6)),
    ]
    for name, args in cases:
        dev = [torch.from_numpy(a).cuda() for a in args]
        got = tk.batched_superstep(*dev)
        torch.cuda.synchronize()
        want = tk.batched_superstep_plain(*dev)
        for g, w, field in zip(got, want, ("C", "par_v", "par_j")):
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(
                    f"kernel != plain on {name} {tuple(args[0].shape)}: "
                    f"{field} differs in {bad} entries")
        print(f"[{tag}] kernel == plain bitwise: {name} "
              f"B,n,K={tuple(args[0].shape)}")


def time_kernel(tk, tag, B, n, K, seed):
    dev = [torch.from_numpy(a).cuda()
           for a in random_state(B, n, K, seed, big_frac=0.6)]
    ms = cuda_ms(lambda: tk.batched_superstep(*dev), 50)
    for _ in range(int(1000 / ms) + 1):  # ~1 s of queued supersteps
        tk.batched_superstep(*dev)
    loaded_mhz = sm_clock_mhz()[0]  # read while the card runs the kernel
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: tk.batched_superstep_plain(*dev), 5)
    got = tk.batched_superstep(*dev)
    want = tk.batched_superstep_plain(*dev)
    err = float((got[0] - want[0]).abs().max())
    candidates = B * n * n * K
    ops_s = SMS * LANES * 1.98e9  # at the H100 SXM boost clock, 1980 MHz
    nbytes = 4 * (6 * B * n * K + 2 * n * n + n + 2 * B * K)
    bound_ops_ms = 1e3 * OPS_PER_CANDIDATE * candidates / ops_s
    bound_bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    at_clock_ms = bound_ops_ms * 1980.0 / loaded_mhz
    print(f"[{tag}] superstep B={B} n={n} K={K}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {max(bound_ops_ms, bound_bytes_ms):.4f}"
          f" ms ({candidates:.3e} candidates x {OPS_PER_CANDIDATE} ops over "
          f"{ops_s:.3e} lane-ops/s; bytes bound {bound_bytes_ms:.4f} ms); "
          f"SM clock under this kernel {loaded_mhz:.0f} MHz, operations bound "
          f"at that clock {at_clock_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=max(bound_ops_ms, bound_bytes_ms),
                bound_by="operations" if bound_ops_ms >= bound_bytes_ms
                else "bytes", candidates=candidates)


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
    import repro_torch.core as T
    from repro_torch.core import leastcost as lc
    from repro_torch.core.graph import validate_mapping
    from repro_torch.kernels.minplus import batched as tk

    tag = card()
    print(tag)
    cur_mhz, max_mhz = sm_clock_mhz()
    print(f"[{tag}] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; SM clock {cur_mhz:.0f} MHz "
          f"(max {max_mhz:.0f} MHz)")

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    lib = tk.load_library()
    print(f"[{tag}] kernel build: nvcc {lib.build_s:.2f} s, cache hit "
          f"{lib.cache_hit}, load {time.perf_counter() - t0:.2f} s, {lib.path.name}")

    # -- phase 2: kernel == plain, bitwise --------------------------------
    check_kernel(tk, tag)
    main_t = time_kernel(tk, tag, 64, N_NODES, P + 1, 11)
    big_t = time_kernel(tk, tag, 8, 4096, P + 1, 12)
    print(f"[{tag}] kernel / bound: {main_t['ms'] / main_t['bound_ms']:.2f}x "
          f"(main shape), {big_t['ms'] / big_t['bound_ms']:.2f}x (n=4096)")

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
    fallbacks[:] = [0, 0.0]
    out, run = drive(placer, stream, lc)
    launches = tk.LAUNCHES
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
    }]}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
