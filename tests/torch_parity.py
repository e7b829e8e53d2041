"""Shared helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX reference (``repro``): both packages get the same seeded
numpy inputs; objects cross between them as numpy arrays."""
import numpy as np

import repro.core as R
import repro_torch.core as T


def port_graph(rg):
    return T.ResourceGraph(rg.cap.copy(), rg.bw.copy(), rg.lat.copy())


def port_df(df):
    return T.DataflowPath(df.creq.copy(), df.breq.copy(), df.src, df.dst)


def light_stream(rg, ps, seed0=500):
    """Reference requests light enough that several fit at once."""
    return [
        R.random_dataflow(rg, p, seed=seed0 + i,
                          creq_range=(0.02, 0.2), breq_range=(0.5, 5.0))
        for i, p in enumerate(ps)
    ]


def same_mapping(a, b):
    """Mappings of the two packages agree exactly (or are both None)."""
    if a is None or b is None:
        return a is None and b is None
    return (a.assign == b.assign and a.route == b.route
            and a.cost == b.cost)


def assert_arrays_equal(ref, port, names):
    for x, y, name in zip(ref, port, names):
        x = np.asarray(x)
        y = y.cpu().numpy() if hasattr(y, "cpu") else np.asarray(y)
        assert x.shape == y.shape, (name, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=name)
