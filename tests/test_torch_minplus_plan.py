"""The move kernel's launch plan (``plan_move``), a plain Python function,
checked on the CPU: the v splits cover every v exactly once, the launch
stays within CUDA's limits, one launch fills an H100 at the engine's rank
blocks, and the splits merge inside a cluster (no partial buffer)."""
import dataclasses

import pytest

from repro_torch.kernels.minplus import minplus as tm

H100_SMS = 132
MAX_BLOCK_SMEM = 232448  # sm_90, dynamic shared memory per block


def _check_plan(p, n_v, n_w, K):
    # v splits: consecutive chunks of v_chunk rows, each non-empty
    assert p.v_chunk % tm.V_ALIGN == 0 and 1 <= p.splits <= tm.MAX_SPLITS
    covered = []
    for s in range(p.splits):
        lo, hi = s * p.v_chunk, min(n_v, (s + 1) * p.v_chunk)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(n_v))
    # k chunks of kt (K itself up to MAX_KT) and column tiles cover (w, k)
    assert 1 <= p.kt <= tm.MAX_KT
    assert (p.kchunks - 1) * p.kt < K <= p.kchunks * p.kt
    if K <= tm.MAX_KT:
        assert p.kt == K  # no dead k
    assert p.w_tile in tm.W_TILES
    assert (p.w_tiles - 1) * p.w_tile < n_w <= p.w_tiles * p.w_tile
    # CUDA's limits: a 1-D grid of whole clusters, at most 8 blocks each or
    # 16 as a non-portable size, and shared memory two blocks of one SM hold
    assert 1 <= p.blocks <= 2**31 - 1 and p.blocks % p.splits == 0
    assert p.splits <= 16  # above 8 the kernel asks for non-portable sizes
    assert tm.MIN_STAGES <= p.stages <= tm.MAX_STAGES
    assert p.smem == tm.smem_bytes(p.kt, p.w_tile, p.stages) <= MAX_BLOCK_SMEM
    assert tm.BLOCKS_PER_SM * (p.smem + 1024) <= tm.SMEM_PER_SM


@pytest.mark.parametrize("K", [1, 2, 9, 10, 33])
@pytest.mark.parametrize("n_v,n_w", [(8, 8), (17, 17), (1000, 300),
                                     (1024, 1024), (1024, 512), (1024, 256),
                                     (4096, 4096), (300, 4096)])
def test_plan_covers_v_and_fits_cuda_limits(n_v, n_w, K):
    _check_plan(tm.plan_move(n_v, n_w, K, H100_SMS), n_v, n_w, K)


@pytest.mark.parametrize("K", [2, 9, 33])
@pytest.mark.parametrize("n_v,n_w", [(1024, 1024), (1024, 512), (1024, 256),
                                     (4096, 4096)])
def test_one_launch_fills_the_card(n_v, n_w, K):
    p = tm.plan_move(n_v, n_w, K, H100_SMS)
    assert p.blocks >= H100_SMS, p


def test_plan_follows_the_cards_cluster_occupancy():
    """With fewer clusters resident than the default assumes (large
    clusters do not all fit), the plan takes fewer splits, never a launch
    the card cannot hold."""
    def max_clusters(kt, w_tile, stages, splits):
        return 0 if splits > 8 else 2 * H100_SMS // splits

    p = tm.plan_move(1024, 1024, 9, H100_SMS, max_clusters)
    _check_plan(p, 1024, 1024, 9)
    assert p.splits <= 8 and p.blocks >= H100_SMS


def test_plan_needs_no_partial_buffer():
    fields = {f.name for f in dataclasses.fields(tm.Plan)}
    assert not any("part" in f for f in fields), fields
    assert not hasattr(tm, "masked_minplus_splits")


def test_empty_move_is_refused():
    with pytest.raises(ValueError, match="empty"):
        tm.plan_move(0, 16, 3, H100_SMS)
