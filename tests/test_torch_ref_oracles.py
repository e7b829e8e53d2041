"""The port's oracle files (``kernels/minplus/ref.py``,
``kernels/place/ref.py``) against the reference's, path for path: the
same names and signatures (``masked_minplus_ref`` takes the k-indexed
thresholds ``breq_k``, as the reference's ``ref.py`` does, not the raw
vector its ``ops.py`` takes), and bitwise the same outputs on the seeded
cases of ``tests/torch_kernel_cases.py``."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import ref as R_minplus
from repro.kernels.place import ref as R_place
from repro_torch.core import problem
from repro_torch.kernels.minplus import ref as T_minplus
from repro_torch.kernels.place import ref as T_place

import torch_kernel_cases as cases


def _equal(port, ref):
    for a, b in zip(port, ref):
        a = a.numpy()
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def _both(port_fn, ref_fn, args):
    _equal(port_fn(*[torch.from_numpy(np.asarray(a)) for a in args]),
           ref_fn(*[jnp.asarray(a) for a in args]))


def test_names_and_signatures_match_the_reference():
    for port, ref, fn in ((T_minplus, R_minplus, "masked_minplus_ref"),
                          (T_place, R_place, "place_window_ref")):
        assert (list(inspect.signature(getattr(port, fn)).parameters)
                == list(inspect.signature(getattr(ref, fn)).parameters))
    assert list(inspect.signature(T_minplus.masked_minplus_ref).parameters) \
        == ["P", "lat", "bw", "breq_k"]
    assert T_minplus.BIG == T_place.BIG == problem.BIG
    assert T_place.EPS_CAP_F32 == problem.EPS_CAP_F32


MINPLUS = [
    ("block_64x64_k9", lambda: cases.minplus_block(64, 64, 9, seed=1)),
    ("block_100x37_k5", lambda: cases.minplus_block(100, 37, 5, seed=2)),
    ("block_33x130_k17", lambda: cases.minplus_block(33, 130, 17, seed=3)),
    ("split_tie", lambda: cases.minplus_split_tie(96, 40, 6)[0]),
    ("big_columns", lambda: cases.minplus_big_columns(80, 48, 9, seed=4)[0]),
]


@pytest.mark.parametrize("name,make", MINPLUS, ids=[m[0] for m in MINPLUS])
def test_masked_minplus_ref_is_the_reference_bitwise(name, make):
    _both(T_minplus.masked_minplus_ref, R_minplus.masked_minplus_ref, make())


PLACE = [
    ("random_64_k9", lambda: cases.place_instance(64, 9, seed=5)),
    ("random_300_k33", lambda: cases.place_instance(300, 33, seed=6)),
    ("ties", cases.place_tie_instance),
    ("nonmonotone", lambda: cases.place_nonmonotone(70, 12, seed=7)),
    ("above_big", lambda: cases.place_above_big(90, 9, seed=8)),
]


@pytest.mark.parametrize("name,make", PLACE, ids=[p[0] for p in PLACE])
def test_place_window_ref_is_the_reference_bitwise(name, make):
    _both(T_place.place_window_ref, R_place.place_window_ref, make())
