"""The superstep kernel's launch plan (``plan_superstep``), a plain Python
function, checked on the CPU: the v splits cover every v exactly once, the
launch stays within CUDA's limits, and a single request fills an H100;
at the region-local shapes of the control planes (n_r = 16 to 64, below
one output tile) the plan is one w tile and at most one v split per
32-row v tile."""
import pytest

from repro_torch.kernels.minplus import batched as tk

H100_SMS = 132
MAX_BLOCK_SMEM = 232448  # sm_90, dynamic shared memory per block


@pytest.mark.parametrize("K", [2, 9, 33])
@pytest.mark.parametrize("n", [10, 1000, 1024, 4096])
@pytest.mark.parametrize("B", [1, 2, 8, 64])
def test_plan_covers_v_and_fits_cuda_limits(B, n, K):
    _check_plan(B, n, K)


def _check_plan(B, n, K):
    p = tk.plan_superstep(B, n, K, H100_SMS)
    # v splits: consecutive chunks of v_chunk rows, each non-empty
    assert p.v_chunk % tk.V_TILE == 0 and 1 <= p.splits <= tk.MAX_SPLITS
    covered = []
    for s in range(p.splits):
        lo, hi = s * p.v_chunk, min(n, (s + 1) * p.v_chunk)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(n))
    # k chunks and request tiles cover every (b, k) pair once
    assert p.kt in tk.KT_SIZES and 1 <= p.kchunk <= p.kt
    assert (p.kchunks - 1) * p.kchunk < K <= p.kchunks * p.kchunk
    assert p.tb * p.tv == tk.ROWS and (p.b_tiles - 1) * p.tb < B <= p.b_tiles * p.tb
    assert (p.w_tiles - 1) * tk.W_TILE < n <= p.w_tiles * tk.W_TILE
    # CUDA's limits: a 1-D grid of whole clusters (at most 16 blocks), 256
    # threads, the shared memory two blocks of one SM can hold
    assert 1 <= p.blocks <= 2**31 - 1 and p.blocks % p.splits == 0
    assert tk.THREADS <= 1024
    assert tk.MIN_STAGES <= p.stages <= tk.MAX_STAGES
    assert p.smem == tk.smem_bytes(p.kt, p.tb, K, p.stages) <= MAX_BLOCK_SMEM
    assert tk.BLOCKS_PER_SM * (p.smem + 1024) <= tk.SMEM_PER_SM
    return p


@pytest.mark.parametrize("K", [4, 6])
@pytest.mark.parametrize("n", [16, 40, 64])
@pytest.mark.parametrize("B", [1, 4, 32])
def test_region_local_plans_cover_v_and_fit(B, n, K):
    p = _check_plan(B, n, K)
    assert p.w_tiles == 1 and p.kchunks == 1 and p.kt >= K
    assert p.splits <= -(-n // tk.V_TILE)


@pytest.mark.parametrize("n", [1024, 4096])
def test_single_request_fills_the_card(n):
    p = tk.plan_superstep(1, n, 9, H100_SMS)
    assert p.blocks >= H100_SMS
    assert p.splits > 1 and p.tb == 1


def test_micro_batch_needs_no_split():
    p = tk.plan_superstep(64, 1024, 9, H100_SMS)
    assert p.splits == 1 and p.blocks >= H100_SMS


def test_workspace_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        tk.make_workspace(1, 16, 3, "cpu")
