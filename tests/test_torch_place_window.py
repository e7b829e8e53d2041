"""The port's capacity-window place op against the reference: the plain
PyTorch version equals the Pallas kernel (interpret mode) and the jnp
oracle bit for bit on ``tests/test_place_kernel.py``'s cases, ties and
infeasible rows; and the op's first-j tie rule stays apart from the DP's
largest-j place step, exactly as in the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.leastcost import _place_step as ref_place_step
from repro.kernels.place import place_window as ref_op
from repro.kernels.place import place_window_ref as ref_oracle
from repro.kernels.place.place import BIG
from repro_torch.core.leastcost import _place_step
from repro_torch.kernels.place import place as tplace
from repro_torch.kernels.place import place_window, place_window_ref

from torch_kernel_cases import place_instance, place_tie_instance


def _all(args):
    j = [jnp.asarray(a) for a in args]
    t = [torch.from_numpy(a) for a in args]
    return [ref_op(*j), ref_oracle(*j), place_window(*t),
            place_window_ref(*t)]


def _assert_all_equal(results):
    (P0, pj0), *rest = results
    for P, pj in rest:
        np.testing.assert_array_equal(np.asarray(P0), np.asarray(P))
        np.testing.assert_array_equal(np.asarray(pj0), np.asarray(pj))
        assert np.asarray(pj).dtype == np.int32


@pytest.mark.parametrize("n,K", [(10, 3), (64, 9), (130, 7), (256, 17),
                                 (300, 33)])
def test_plain_matches_reference_bitwise(n, K):
    before = tplace.LAUNCHES
    _assert_all_equal(_all(place_instance(n, K, seed=n + K)))
    assert tplace.LAUNCHES == before  # CPU tensors never reach the kernel


def test_ties_take_the_first_j_and_infeasible_rows_give_big_zero():
    results = _all(place_tie_instance())
    _assert_all_equal(results)
    P, pj = results[2]
    assert pj[0].tolist() == [0, 0, 0, 0, 0]
    assert pj[1].tolist() == [0, 1, 1, 1, 1]
    assert (P[3] == float(BIG)).all() and (pj[3] == 0).all()


def test_tie_rule_differs_from_the_dp_place_step_as_in_the_reference():
    """``_place_step`` and ``place_window`` agree in P and differ in pj,
    the same way in both packages: the place kernel must not serve the DP."""
    C, cap, prefix = place_tie_instance()
    rP, rpj = ref_place_step(jnp.asarray(C), jnp.asarray(cap),
                             jnp.asarray(prefix))
    oP, opj = ref_oracle(jnp.asarray(C), jnp.asarray(cap), jnp.asarray(prefix))
    t = [torch.from_numpy(a) for a in (C, cap, prefix)]
    P, pj = _place_step(*t)
    wP, wpj = place_window(*t)
    np.testing.assert_array_equal(np.asarray(rP), P.numpy())
    np.testing.assert_array_equal(np.asarray(rpj), pj.numpy())
    np.testing.assert_array_equal(P.numpy(), wP.numpy())
    differ = np.asarray(rpj) != np.asarray(opj)
    assert differ.any()
    np.testing.assert_array_equal(pj.numpy() != wpj.numpy(), differ)
    assert (pj.numpy()[differ] > wpj.numpy()[differ]).all()


def test_kernel_entry_rejects_cpu_tensors():
    t = [torch.from_numpy(a) for a in place_instance(10, 3, seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        tplace.place_window_cuda(*t)
