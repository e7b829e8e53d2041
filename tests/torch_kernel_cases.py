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


def _breq_thresholds(rng, K):
    """k-indexed bandwidth thresholds as the op builds them: BIG at k = 0
    and at k = K - 1, random in between."""
    mid = (rng.random(max(K - 2, 0)) * 80).astype(np.float32)
    ends = [np.full(1, BIG, np.float32)] * (1 if K == 1 else 2)
    return np.concatenate([ends[0], mid, *ends[1:]]).astype(np.float32)


def minplus_block(n_v, n_w, K, seed, inf_frac=0.4):
    """The move kernel's rectangular inputs (P, lat, bw, breq_k): a rank's
    link columns, with the k-indexed thresholds."""
    rng = np.random.default_rng(seed)
    P = np.where(rng.random((n_v, K)) < inf_frac, BIG,
                 rng.random((n_v, K)) * 10).astype(np.float32)
    lat = np.where(rng.random((n_v, n_w)) < 0.5, BIG,
                   rng.random((n_v, n_w)) * 5 + 0.1).astype(np.float32)
    bw = (rng.random((n_v, n_w)) * 100).astype(np.float32)
    return [P, lat, bw, _breq_thresholds(rng, K)]


def minplus_split_tie(n_v, n_w, K):
    """Cost 0 only at two v far apart (in different v splits of the move's
    launch); every column reaches cost 1 from both, the first must win."""
    first, second = n_v // 3, 2 * n_v // 3 + 1
    P = np.full((n_v, K), BIG, np.float32)
    P[[first, second]] = 0.0
    lat = np.ones((n_v, n_w), np.float32)
    bw = np.full((n_v, n_w), 100.0, np.float32)
    breq_k = np.ones((K,), np.float32)
    return [P, lat, bw, breq_k], (first, second)


def minplus_big_columns(n_v, n_w, K, seed):
    """P = BIG on most rows and lat = BIG on every feasible link of a third
    of the columns: there every candidate is at or above BIG (P + BIG rounds
    to BIG, BIG + BIG is 2e18), so those columns must give (BIG, 0)."""
    P, lat, bw, breq_k = minplus_block(n_v, n_w, K, seed, inf_frac=0.8)
    cols = np.arange(0, n_w, 3)
    lat[:, cols] = BIG
    return [P, lat, bw, breq_k], cols


def place_nonmonotone(n, K, seed):
    """A capacity window whose prefix is not monotone (signed steps), so
    feasibility is not a suffix of j."""
    C, cap, _ = place_instance(n, K, seed)
    rng = np.random.default_rng(seed + 1)
    prefix = np.concatenate([[0.0], np.cumsum(rng.random(K - 1) * 6 - 3)])
    return C, cap, prefix.astype(np.float32)


def place_above_big(n, K, seed):
    """C entries above BIG (inf and 2e18) beside BIG and finite ones: the
    reference's min over the whole candidate row (BIG where infeasible or
    j > k) decides which j wins."""
    C, cap, prefix = place_instance(n, K, seed)
    rng = np.random.default_rng(seed + 2)
    r = rng.random((n, K))
    C = np.where(r < 0.2, np.float32(np.inf),
                 np.where(r < 0.4, np.float32(2e18), C)).astype(np.float32)
    return C, cap, prefix
