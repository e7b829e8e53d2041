"""The port's fused superstep: the plain PyTorch version against the
reference's ``batched_superstep_ref`` bit for bit (random states, forced
ties, BIG clamp, padded columns), the device control word, and — on a card
only — the CUDA kernel against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.leastcost import _leastcost_dp_batched as ref_dp
from repro.core.problem import BIG, stack_requests as ref_stack
from repro.kernels.minplus import batched as rk
from repro_torch.core.leastcost import _leastcost_dp_batched as port_dp
from repro_torch.core.problem import stack_requests as port_stack
from repro_torch.kernels.minplus import batched as tk

from torch_parity import (assert_arrays_equal, light_stream, port_df,
                          port_graph)

NAMES = ("C", "par_v", "par_j")


def random_state(B, n, K, seed, big_frac=0.4):
    """The reference test's random superstep inputs, as numpy arrays."""
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
    creq = rng.random((B, K - 1)).astype(np.float32) * 2
    prefix = np.concatenate(
        [np.zeros((B, 1), np.float32), np.cumsum(creq, axis=1)], axis=1)
    breq_k = np.concatenate(
        [np.full((B, 1), BIG, np.float32),
         (rng.random((B, K - 2)) * 60).astype(np.float32),
         np.full((B, 1), BIG, np.float32)], axis=1)
    return [C, pv, pj, lat, bw, cap, prefix, breq_k]


def tie_state(B=2, n=16, K=4):
    """Zero-cost states only at v in {0, 1}, j in {1, 2}: every other row
    reaches cost 1 through a v-tie, and place ties between j=1 and j=2."""
    C = np.full((B, n, K), BIG, np.float32)
    C[:, :2, 1:3] = 0.0
    pv = np.full((B, n, K), -1, np.int32)
    pj = np.full((B, n, K), -1, np.int32)
    lat = np.full((n, n), 1.0, np.float32)
    np.fill_diagonal(lat, BIG)
    bw = np.full((n, n), 100.0, np.float32)
    cap = np.full((n,), 50.0, np.float32)
    prefix = np.tile(np.arange(K, dtype=np.float32)[None, :], (B, 1)) * np.float32(0.1)
    breq_k = np.concatenate([np.full((B, 1), BIG, np.float32),
                             np.full((B, K - 2), 1.0, np.float32),
                             np.full((B, 1), BIG, np.float32)], axis=1)
    return [C, pv, pj, lat, bw, cap, prefix, breq_k]


def both(args):
    ref = rk.batched_superstep_ref(*(jnp.asarray(a) for a in args))
    port = tk.batched_superstep_plain(*(torch.from_numpy(a) for a in args))
    return ref, port


@pytest.mark.parametrize("B,n,K,seed", [(3, 12, 6, 0), (2, 13, 5, 1),
                                        (4, 9, 9, 2), (1, 7, 2, 3)])
def test_plain_matches_reference_on_random_states(B, n, K, seed):
    ref, port = both(random_state(B, n, K, seed))
    assert_arrays_equal(ref, port, NAMES)


def test_plain_breaks_ties_like_reference():
    ref, port = both(tie_state())
    assert_arrays_equal(ref, port, NAMES)
    Cn, pvn, pjn = (x.numpy() for x in port)
    assert (Cn[:, 2:, 1:3] == 1.0).all()
    assert (pvn[:, 2:, 1:3] == 0).all()  # first v wins the move tie
    assert (pjn[:, 2:, 2] == 2).all()  # largest j wins the place tie


def test_plain_big_overflow_leaves_state_unchanged():
    args = random_state(B=2, n=10, K=5, seed=9, big_frac=1.0)
    ref, port = both(args)
    assert_arrays_equal(ref, port, NAMES)
    np.testing.assert_array_equal(port[0].numpy(), args[0])


def test_padded_columns_stay_masked_and_match_reference():
    rg = R.waxman(12, seed=11)
    dfs = light_stream(rg, [3, 6], seed0=90)  # p_eff 3 vs 6: ghost columns
    tj, p_max = ref_stack(rg, dfs)
    ref = ref_dp(tj, B=2, n=12, p=p_max, max_rounds=11, impl="ref")
    tt, _ = port_stack(port_graph(rg), [port_df(d) for d in dfs], device="cpu")
    port = port_dp(tt, B=2, n=12, p=p_max, max_rounds=11, impl="plain")
    assert_arrays_equal(ref[:5], port[:5], NAMES + ("cost", "j"))
    assert (port[0][0, :, 4:] >= BIG / 2).all()


def test_control_word_freezes_state_after_fixpoint():
    """A superstep with ``active == 0`` is a copy and leaves the word alone
    except for clearing ``changed``; an active one advances ``t``."""
    args = [torch.from_numpy(a) for a in random_state(2, 8, 4, seed=5)]
    flags = torch.tensor([3, 0, 1, 10], dtype=torch.int32)
    out = tk.plain_superstep(*args, flags=flags)
    for a, b in zip(out, args[:3]):
        assert torch.equal(a, b)
    assert flags.tolist() == [3, 0, 0, 10]
    flags = torch.tensor([9, 1, 0, 10], dtype=torch.int32)
    out = tk.plain_superstep(*args, flags=flags)
    for a, b in zip(out, tk.batched_superstep_plain(*args)):
        assert torch.equal(a, b)
    assert flags.tolist() == [10, 0, 0, 10]  # round cap reached


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,K,seed", [(3, 12, 6, 0), (5, 45, 9, 1),
                                        (1, 33, 2, 2), (16, 100, 9, 3)])
def test_kernel_matches_plain_on_card(B, n, K, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for args in (random_state(B, n, K, seed), tie_state(),
                 random_state(B, n, K, seed, big_frac=1.0)):
        dev = [torch.from_numpy(a).cuda() for a in args]
        before = tk.LAUNCHES
        got = tk.batched_superstep(*dev)
        torch.cuda.synchronize()
        assert tk.LAUNCHES == before + 1
        want = tk.batched_superstep_plain(*dev)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
