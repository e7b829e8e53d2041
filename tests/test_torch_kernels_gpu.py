"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on a card.  Every test here is marked ``gpu`` and skips without one;
the module imports no JAX, so on a machine with a card it runs as

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from repro_torch.core.problem import BIG
from repro_torch.kernels.minplus import batched as tk
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus.ops import _breq_k
from repro_torch.kernels.place import place as tplace

from torch_kernel_cases import (REGION_SHAPES, minplus_big_columns,
                                minplus_block,
                                minplus_instance, minplus_split_tie,
                                place_above_big, place_instance,
                                place_nonmonotone, place_tie_instance,
                                random_state, relaxation_state,
                                split_tie_state, tie_state)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K,seed", [(3, 12, 6, 0), (5, 45, 9, 1),
                                        (1, 33, 2, 2), (16, 100, 9, 3)])
def test_kernel_matches_plain_on_card(card, B, n, K, seed):
    for args in (random_state(B, n, K, seed), tie_state(),
                 random_state(B, n, K, seed, big_frac=1.0)):
        dev = [torch.from_numpy(a).to(card) for a in args]
        before = tk.LAUNCHES
        got = tk.batched_superstep(*dev)
        assert tk.LAUNCHES == before + 1
        _equal(got, tk.batched_superstep_plain(*dev))


def _superstep_equal(card, args, **kw):
    dev = [torch.from_numpy(a).to(card) for a in args]
    before = tk.LAUNCHES
    got = tk.batched_superstep(*dev, **kw)
    assert tk.LAUNCHES == before + 1
    want = tk.batched_superstep_plain(*dev)
    _equal(got, want)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K,big_frac", [
    (1, 1024, 9, 0.4), (1, 4096, 9, 0.4),  # the split-v path
    (1, 1024, 9, 1.0), (64, 300, 9, 1.0),  # BIG + lat above BIG
    (3, 50, 2, 0.4), (1, 1024, 2, 0.4),  # K = 2
    (5, 130, 33, 0.4), (1, 1024, 33, 0.4),  # K above the template limit
    (64, 1024, 9, 0.4),  # the micro-batch shape
])
def test_superstep_regimes_match_plain_on_card(card, B, n, K, big_frac):
    ws = tk.make_workspace(B, n, K, card)
    if B == 1 and n >= 1024:
        assert ws.plan.splits > 1 and ws.plan.blocks >= 132, ws.plan
    args = random_state(B, n, K, seed=B * 7 + n + K, big_frac=big_frac)
    got = _superstep_equal(card, args, workspace=ws)
    if big_frac == 1.0:  # no state can improve
        assert torch.equal(got[0].cpu(), torch.from_numpy(args[0]))
    assert ws.ticket.item() == 0  # left for the next launch


@pytest.mark.gpu
def test_superstep_smem_formula_matches_kernel(card):
    lib = tk.load_library().lib
    for kt in tk.KT_SIZES:
        for tb in (1, 2, 4, 8, 16):
            for K in (kt, 33):
                for stages in range(tk.MIN_STAGES, tk.MAX_STAGES + 1):
                    assert lib.batched_superstep_smem(kt, tb, K, stages) == \
                        tk.smem_bytes(kt, tb, K, stages)


@pytest.mark.gpu
def test_superstep_first_v_wins_across_splits_on_card(card):
    args, (first, second) = split_tie_state()
    ws = tk.make_workspace(1, args[0].shape[1], args[0].shape[2], card)
    assert first // ws.plan.v_chunk != second // ws.plan.v_chunk, ws.plan
    Cn, pvn, _ = _superstep_equal(card, args, workspace=ws)
    others = [w for w in range(args[0].shape[1]) if w not in (first, second)]
    assert (Cn[0, others, 1:3] == 1.0).all()
    assert (pvn[0, others, 1:3] == first).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K", [(1, 1024, 9), (4, 200, 9), (3, 64, 5)])
@pytest.mark.parametrize("max_rounds", [50, 3], ids=["fixpoint", "round_cap"])
def test_superstep_flags_sequence_matches_plain_on_card(card, B, n, K,
                                                        max_rounds):
    """Twelve supersteps on one workspace with the device control word,
    across the fixpoint (or the round cap): flags and state after every
    step equal ``plain_superstep``'s."""
    t, stopped = _flags_sequence(card, B, n, K, max_rounds)
    assert stopped
    assert t == 3 if max_rounds == 3 else 3 < t < 12  # cap, or a fixpoint


def _flags_sequence(card, B, n, K, max_rounds):
    """Twelve supersteps of the kernel and of the plain version from the
    DP's cold start; returns the round count and whether it stopped."""
    args = [torch.from_numpy(a).to(card) for a in relaxation_state(B, n, K, 8)]
    ws = tk.make_workspace(B, n, K, card)
    fk = torch.tensor([0, 1, 0, max_rounds], dtype=torch.int32, device=card)
    fp = fk.clone()
    sk = sp = tuple(args[:3])
    stopped = False
    for _ in range(12):
        sk = tk.batched_superstep(*sk, *args[3:], flags=fk, workspace=ws)
        sp = tk.plain_superstep(*sp, *args[3:], flags=fp)
        _equal(sk, sp)
        assert fk.tolist() == fp.tolist()
        stopped |= fk[1].item() == 0
    return fk[0].item(), stopped


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K", REGION_SHAPES)
def test_superstep_region_local_shapes_match_plain_on_card(card, B, n, K):
    """The control planes' shapes: random states, ties, and BIG overflow
    (every C and half of lat at BIG, so P + lat lands above BIG)."""
    ws = tk.make_workspace(B, n, K, card)
    assert ws.plan.w_tiles == 1
    seed = B * 100 + n + K
    _superstep_equal(card, random_state(B, n, K, seed), workspace=ws)
    _superstep_equal(card, tie_state(B, n, K), workspace=ws)
    args = random_state(B, n, K, seed + 1, big_frac=1.0)
    got = _superstep_equal(card, args, workspace=ws)
    assert torch.equal(got[0].cpu(), torch.from_numpy(args[0]))
    assert ws.ticket.item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K", [(1, 16, 4), (4, 40, 6), (32, 64, 6)])
@pytest.mark.parametrize("max_rounds", [50, 4], ids=["fixpoint", "round_cap"])
def test_superstep_region_local_flags_sequence_on_card(card, B, n, K,
                                                       max_rounds):
    """The flags sequence at region-local shapes, with the warm solves'
    round cap of 4."""
    t, stopped = _flags_sequence(card, B, n, K, max_rounds)
    assert stopped
    assert t == 4 if max_rounds == 4 else 4 < t < 12  # cap, or a fixpoint


def _minplus_cases():
    for n, K in [(8, 2), (17, 3), (50, 7), (128, 9), (130, 3), (256, 33),
                 (300, 17), (1024, 9)]:
        yield f"{n}x{K}", minplus_instance(n, K, seed=n * 1000 + K)
    P, lat, bw, _ = minplus_instance(32, 4, seed=7)
    yield "infeasible", (P, lat, bw, np.full((3,), BIG, np.float32))
    yield "ties", (np.zeros((16, 3), np.float32), np.ones((16, 16), np.float32),
                   np.full((16, 16), 100.0, np.float32),
                   np.ones((2,), np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("name,args", list(_minplus_cases()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_masked_minplus_kernel_matches_plain_on_card(card, name, args):
    P, lat, bw, breq = (torch.from_numpy(a).to(card) for a in args)
    bq = _breq_k(breq, P.shape[1])
    before = tmp.LAUNCHES
    got = tmp.masked_minplus_cuda(P, lat, bw, bq)
    assert tmp.LAUNCHES == before + 1
    _equal(got, tmp.masked_minplus_plain(P, lat, bw, bq))
    lo, hi = lat.shape[1] // 3, lat.shape[1] // 3 + lat.shape[1] // 2 + 1
    block = tmp.masked_minplus_cuda(P, lat[:, lo:hi].contiguous(),
                                    bw[:, lo:hi].contiguous(), bq)
    _equal(block, (got[0][lo:hi], got[1][lo:hi]))


@pytest.mark.gpu
@pytest.mark.parametrize("n,K", [(10, 3), (64, 9), (130, 7), (256, 17),
                                 (300, 33), (4096, 9)])
def test_place_window_kernel_matches_plain_on_card(card, n, K):
    for args in (place_instance(n, K, seed=n + K), place_tie_instance()):
        C, cap, prefix = (torch.from_numpy(a).to(card) for a in args)
        before = tplace.LAUNCHES
        got = tplace.place_window_cuda(C, cap, prefix)
        assert tplace.LAUNCHES == before + 1
        _equal(got, tplace.place_window_plain(C, cap, prefix))


def _move_equal(card, args):
    dev = [torch.from_numpy(a).to(card) for a in args]
    before = tmp.LAUNCHES
    got = tmp.masked_minplus_cuda(*dev)
    assert tmp.LAUNCHES == before + 1  # one launch per call, any shape
    _equal(got, tmp.masked_minplus_plain(*dev))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("K", [2, 9, 33])
@pytest.mark.parametrize("n_w", [1024, 512, 256, 17, 130, 300])
def test_masked_minplus_rank_blocks_match_plain_on_card(card, n_w, K):
    """The engine's rank blocks (n_w = n / D) and unaligned widths, which
    take the kernel's 4-byte copies."""
    _move_equal(card, minplus_block(1024, n_w, K, seed=n_w * 100 + K))


@pytest.mark.gpu
@pytest.mark.parametrize("n_w,K", [(1024, 9), (256, 9), (130, 33)])
def test_masked_minplus_first_v_wins_across_splits_on_card(card, n_w, K):
    args, (first, second) = minplus_split_tie(1024, n_w, K)
    index = torch.device(card).index or 0
    plan = tmp._plan_on(index, 1024, n_w, K)
    assert plan.splits > 1 and first // plan.v_chunk != second // plan.v_chunk
    C, pv = _move_equal(card, args)
    assert (C == 1.0).all() and (pv == first).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n_w,K", [(1024, 9), (300, 2), (256, 33)])
def test_masked_minplus_big_columns_on_card(card, n_w, K):
    args, cols = minplus_big_columns(1024, n_w, K, seed=n_w + K)
    C, pv = _move_equal(card, args)
    cols = torch.from_numpy(cols).to(card)
    assert (C[cols] == float(BIG)).all() and (pv[cols] == 0).all()


def _place_equal(card, args):
    C, cap, prefix = (torch.from_numpy(a).to(card) for a in args)
    before = tplace.LAUNCHES
    got = tplace.place_window_cuda(C, cap, prefix)
    assert tplace.LAUNCHES == before + 1
    _equal(got, tplace.place_window_plain(C, cap, prefix))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n,K", [(300, 9), (1000, 33), (129, 17), (64, 40)])
def test_place_window_nonmonotone_and_above_big_on_card(card, n, K):
    """A prefix that is not monotone, and C above BIG (the kernel's exact
    rescan); K = 40 takes the one-thread-per-(v, k) kernel."""
    _place_equal(card, place_nonmonotone(n, K, seed=n + K))
    _place_equal(card, place_above_big(n, K, seed=n * K))


@pytest.mark.gpu
def test_place_window_ties_and_infeasible_rows_on_card(card):
    P, pj = _place_equal(card, place_tie_instance())
    assert pj[0].tolist() == [0] * 5 and pj[1].tolist() == [0, 1, 1, 1, 1]
    assert (P[3] == float(BIG)).all() and (pj[3] == 0).all()


@pytest.mark.gpu
def test_place_window_large_slice_on_card(card):
    """A 2^16-row slice of the throughput shape at K = 33."""
    _place_equal(card, place_instance(2**16, 33, seed=16))


@pytest.mark.gpu
def test_move_smem_formula_matches_kernel(card):
    lib = tmp.load_library().lib
    for kt in range(1, tmp.MAX_KT + 1):
        for w_tile in tmp.W_TILES:
            for stages in range(tmp.MIN_STAGES, tmp.MAX_STAGES + 1):
                assert lib.masked_minplus_smem(kt, w_tile, stages) == \
                    tmp.smem_bytes(kt, w_tile, stages)
