"""The port's masked min-plus move op against the reference: the plain
PyTorch version equals the Pallas kernel (interpret mode) and the jnp
oracle bit for bit, on ``tests/test_kernels.py``'s cases, on a rectangular
column block, and through the op's CPU dispatch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import masked_minplus as ref_op
from repro.kernels.minplus import masked_minplus_ref as ref_oracle
from repro.kernels.minplus.minplus import BIG
from repro_torch.kernels.minplus import minplus as tmp
from repro_torch.kernels.minplus import masked_minplus, masked_minplus_ref

from torch_kernel_cases import minplus_instance


def _both(args, **ref_kw):
    """(reference op, reference oracle, port op, port ref) results."""
    j = [jnp.asarray(a) for a in args]
    t = [torch.from_numpy(a) for a in args]
    return (ref_op(*j, **ref_kw), ref_oracle(*j), masked_minplus(*t),
            masked_minplus_ref(*t))


def _assert_all_equal(results):
    (C0, pv0), *rest = results
    for C, pv in rest:
        np.testing.assert_array_equal(np.asarray(C0), np.asarray(C))
        np.testing.assert_array_equal(np.asarray(pv0), np.asarray(pv))
        assert np.asarray(pv).dtype == np.int32


@pytest.mark.parametrize("n,K", [(8, 2), (17, 3), (50, 7), (128, 9), (130, 3),
                                 (256, 33), (300, 17)])
def test_plain_matches_reference_bitwise(n, K):
    before = tmp.LAUNCHES
    _assert_all_equal(_both(minplus_instance(n, K, seed=n * 1000 + K)))
    assert tmp.LAUNCHES == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("tiles", [(8, 8, 8), (128, 8, 8), (8, 128, 128),
                                   (64, 64, 16)])
def test_plain_matches_every_reference_tiling(tiles):
    _assert_all_equal(_both(minplus_instance(100, 5, seed=42), tiles=tiles))


def test_all_infeasible_column():
    P, lat, bw, breq = minplus_instance(32, 4, seed=7)
    breq = np.full((3,), BIG, np.float32)  # nothing satisfies any bandwidth
    results = _both((P, lat, bw, breq))
    _assert_all_equal(results)
    C, pv = results[2]
    assert bool((C >= BIG / 2).all()) and bool((pv == 0).all())


def test_ties_break_to_first_v():
    n, K = 16, 3
    P = np.zeros((n, K), np.float32)  # every v offers cost 0
    lat = np.ones((n, n), np.float32)
    bw = np.full((n, n), 100.0, np.float32)
    breq = np.asarray([1.0, 1.0], np.float32)
    results = _both((P, lat, bw, breq))
    _assert_all_equal(results)
    assert (results[2][1][:, 1:] == 0).all()


def test_big_plus_lat_is_clamped_to_big():
    """An all-BIG P over BIG links is BIG + BIG = 2e18 before the clamp."""
    P, lat, bw, breq = minplus_instance(24, 4, seed=3, inf_frac=1.0)
    lat[:] = BIG
    bw[:] = 100.0
    breq[:] = 1.0
    results = _both((P, lat, bw, breq))
    _assert_all_equal(results)
    assert (results[2][0] == float(BIG)).all()


@pytest.mark.parametrize("cols", [(0, 17), (20, 50), (37, 38)])
def test_rectangular_block_equals_column_slice(cols):
    """The engine's case: the owned link columns of a square instance."""
    lo, hi = cols
    P, lat, bw, breq = minplus_instance(50, 7, seed=50 * 1000 + 7)
    bq = np.concatenate([[BIG], breq, [BIG] * (7 - 1 - len(breq))])
    bq = torch.from_numpy(bq.astype(np.float32))
    C_sq, pv_sq = masked_minplus(*(torch.from_numpy(a)
                                   for a in (P, lat, bw, breq)))
    C, pv = tmp.masked_minplus_plain(
        torch.from_numpy(P), torch.from_numpy(lat[:, lo:hi].copy()),
        torch.from_numpy(bw[:, lo:hi].copy()), bq)
    assert C.shape == (hi - lo, 7)
    assert torch.equal(C, C_sq[lo:hi]) and torch.equal(pv, pv_sq[lo:hi])


def test_kernel_entry_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in minplus_instance(8, 3, seed=1)]
    bq = torch.full((3,), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tmp.masked_minplus_cuda(args[0], args[1], args[2], bq)
