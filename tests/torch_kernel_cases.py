"""Seeded numpy inputs shared by the port's kernel tests: the CPU parity
tests feed them to both packages, the ``gpu`` tests to the kernel and its
plain version.  Imports no JAX, so the ``gpu`` tests run on a card's host."""
import numpy as np

from repro_torch.core.problem import BIG


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


def split_tie_state(n=1024, K=4):
    """One request whose only zero-cost states sit at two v far apart, in
    different v splits of the kernel's B = 1 launch: every other column
    reaches cost 1 from both, and the first of the two must win."""
    B = 1
    C = np.full((B, n, K), BIG, np.float32)
    first, second = n // 3, 2 * n // 3 + 1
    C[:, [first, second], :] = 0.0
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
    return [C, pv, pj, lat, bw, cap, prefix, breq_k], (first, second)


def relaxation_state(B, n, K, seed):
    """The DP's cold start on a random network: cost 0 at each request's
    source with 0 nodes placed, BIG elsewhere, parents -1.  Every node can
    take at least one dataflow node (cap >= 2 > any single creq)."""
    C, pv, pj, lat, bw, cap, prefix, breq_k = random_state(B, n, K, seed)
    cap = cap + np.float32(2.0)
    src = np.random.default_rng(seed + 1).integers(0, n, size=B)
    C = np.full((B, n, K), BIG, np.float32)
    C[np.arange(B), src, 0] = 0.0
    pv = np.full((B, n, K), -1, np.int32)
    return [C, pv, pv.copy(), lat, bw, cap, prefix, breq_k]


def minplus_instance(n, K, seed, inf_frac=0.4):
    """``tests/test_kernels.py``'s random instance, as numpy arrays."""
    rng = np.random.default_rng(seed)
    P = np.where(rng.random((n, K)) < inf_frac, BIG,
                 rng.random((n, K)) * 10).astype(np.float32)
    lat = np.where(rng.random((n, n)) < 0.5, BIG,
                   rng.random((n, n)) * 5 + 0.1).astype(np.float32)
    bw = (rng.random((n, n)) * 100).astype(np.float32)
    breq = (rng.random(max(K - 1, 1)) * 80).astype(np.float32)
    return P, lat, bw, breq[: K - 1]


def place_instance(n, K, seed):
    """``tests/test_place_kernel.py``'s random instance, as numpy arrays."""
    rng = np.random.default_rng(seed)
    C = np.where(rng.random((n, K)) < 0.4, BIG, rng.random((n, K)) * 10)
    cap = (rng.random(n) * 8).astype(np.float32)
    creq = rng.random(K - 1) * 3
    prefix = np.concatenate([[0.0], np.cumsum(creq)]).astype(np.float32)
    return C.astype(np.float32), cap, prefix


def place_tie_instance():
    """Rows with equal minima at several j, and a row with no feasible j."""
    n, K = 6, 5
    C = np.full((n, K), BIG, np.float32)
    C[0] = 2.0  # every j ties
    C[1] = [3.0, 1.0, 1.0, 4.0, 1.0]
    C[2] = [BIG, 0.0, BIG, 0.0, 0.0]
    C[4] = [5.0, 5.0, 0.5, 0.5, 7.0]
    C[5] = [1.0, 2.0, 1.0, 2.0, 1.0]
    cap = np.asarray([10.0, 10.0, 1.0, -1.0, 0.6, 10.0], np.float32)
    prefix = np.asarray([0.0, 0.5, 1.0, 1.5, 2.0], np.float32)
    return C, cap, prefix
