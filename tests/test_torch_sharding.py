"""The port's logical-axis rules (``repro_torch.dist.sharding``) against the
reference's, with no ranks: ``Rules`` reads only a mesh's axis names and
sizes, so the reference runs on ``jax.sharding.AbstractMesh`` and the port
on its shape-only ``launch.mesh.Mesh``.  For every parameter and cache leaf
of all ten archs (published and SMOKE configs), the four rule sets and five
meshes, the port's ``spec`` must equal the reference's ``PartitionSpec``
exactly, and its placements must be that spec's (``spec_of`` inverts
them).  The port's logical axes must be the reference's, names crossed
through ``models/carry.py``."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

import repro.configs as RC
from repro.dist import sharding as R_shd
from repro.launch import steps as R_steps
from repro.models import registry as R_reg
from repro.models.common import dtype_of as r_dtype_of
from repro.models.config import SHAPES as R_SHAPES

import repro_torch.configs as TC
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps as T_steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as T_reg
from repro_torch.models.carry import STACKED
from repro_torch.models.common import dtype_of
from repro_torch.models.config import SHAPES

MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (4, 1)),
          (("data", "model"), (2, 2)),
          (("data", "model"), (1, 4))]
SERVE = ("prefill_32k", "decode_32k")


def rules(module, name, mesh, cfg):
    if name == "serve":
        return module.serve_rules(mesh, batch=128, kv_heads=cfg.n_kv_heads,
                                  seq=32768)
    return getattr(module, f"train_{name}_rules")(mesh)


RULES = ("compute", "seqpar", "state", "serve")


def meshes():
    for names, sizes in MESHES:
        yield (AbstractMesh(sizes, names),
               Mesh(torch.device("cpu"), dict(zip(names, sizes))))


def tup(spec):
    return tuple(spec)


def ref_leaves(tree, path=()):
    """(path, leaf) of a nested dict, keys in the reference's sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from ref_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def port_names(path, shape):
    """The port's names of the reference leaf ``path`` (one per layer of a
    stacked leaf) with the axes' leading ``"layers"`` dropped or not."""
    if path[0] in STACKED:
        return [".".join((path[0], str(i)) + path[1:]) for i in range(shape[0])]
    return [".".join(path)]


@pytest.fixture(scope="module")
def abstract_models():
    out = {}
    for arch in RC.ARCHS:
        for smoke in (False, True):
            rcfg = RC.get_config(arch, smoke=smoke)
            tcfg = TC.get_config(arch, smoke=smoke)
            out[arch, smoke] = (rcfg, tcfg, R_steps.abstract_model(rcfg),
                                T_steps.abstract_model(tcfg))
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_specs_and_axes_match_reference(arch, smoke, abstract_models):
    rcfg, tcfg, (r_shapes, r_axes), (t_shapes, t_axes) = \
        abstract_models[arch, smoke]
    shapes = dict(ref_leaves(jax.tree.map(lambda s: tuple(s.shape), r_shapes,
                                          is_leaf=lambda x: hasattr(x, "shape"))))
    axes = dict(ref_leaves(r_axes))
    # the axes, name for name
    want_axes = {}
    for path, a in axes.items():
        for name in port_names(path, shapes[path]):
            want_axes[name] = a[1:] if path[0] in STACKED else a
    assert t_axes == want_axes
    assert list(t_axes) == list(t_shapes)
    n = 0
    for rmesh, tmesh in meshes():
        for rname in RULES:
            r_rules = rules(R_shd, rname, rmesh, rcfg)
            t_rules = rules(shd, rname, tmesh, tcfg)
            for path, a in axes.items():
                want = tup(r_rules.spec(a, shapes[path]))
                # the stacked leaf's layer axis maps to no mesh axis
                assert not want or path[0] not in STACKED or want[0] is None
                for name in port_names(path, shapes[path]):
                    shape = tuple(t_shapes[name].shape)
                    full = (("layers",) + t_axes[name] if path[0] in STACKED
                            else t_axes[name])
                    assert t_rules.spec(full, shapes[path]) == want
                    got = t_rules.spec(t_axes[name], shape)
                    assert got == (want[1:] if path[0] in STACKED else want)
                    pl = t_rules.placements(t_axes[name], shape)
                    assert len(pl) == len(tmesh.shape)
                    assert shd.spec_of(tmesh, pl, len(shape)) == got
                    n += 1
    assert n > 0


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_cache_specs_match_reference(arch, smoke):
    """The decode and prefill caches under ``serve_rules``, in the compute
    dtype, on every mesh; shapes from ``abstract_cache``."""
    rcfg, tcfg = RC.get_config(arch, smoke=smoke), TC.get_config(arch,
                                                                smoke=smoke)
    for shape_name in SERVE:
        r_c, r_a = R_steps.abstract_cache(rcfg, R_SHAPES[shape_name],
                                          r_dtype_of(rcfg.dtype))
        t_c, t_a = T_steps.abstract_cache(tcfg, SHAPES[shape_name],
                                          dtype_of(tcfg.dtype))
        r_shape = dict(ref_leaves(jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), r_c,
            is_leaf=lambda x: hasattr(x, "shape"))))
        t_shape = dict(ref_leaves(shd.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            t_c)))
        assert t_shape == r_shape
        assert dict(ref_leaves(t_a)) == dict(ref_leaves(r_a))
        assert all(t.device.type == "meta" for _, t in ref_leaves(t_c))
        for rmesh, tmesh in meshes():
            rr = rules(R_shd, "serve", rmesh, rcfg)
            tr = rules(shd, "serve", tmesh, tcfg)
            for path, a in ref_leaves(r_a):
                assert tr.spec(a, r_shape[path][0]) == tup(
                    rr.spec(a, r_shape[path][0])), (path, tmesh.shape)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-2b",
                                  "whisper-medium"])
def test_batch_shardings_match_reference(arch, shape_name):
    """``input_specs`` (meta tensors) and ``batch_shardings`` under the
    compute, seqpar and serve rules, masked and not."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    for masked in ((False, True) if SHAPES[shape_name].kind == "train"
                   else (False,)):
        r_specs = R_reg.input_specs(rcfg, R_SHAPES[shape_name], masked=masked)
        t_specs = T_reg.input_specs(tcfg, SHAPES[shape_name], masked=masked)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in r_specs.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in t_specs.items()}
        assert all(v.device.type == "meta" for v in t_specs.values())
        for rmesh, tmesh in meshes():
            for rname in ("compute", "seqpar", "serve"):
                want = R_shd.batch_shardings(rules(R_shd, rname, rmesh, rcfg),
                                             r_specs)
                got = shd.batch_shardings(rules(shd, rname, tmesh, tcfg),
                                          t_specs)
                assert {k: s.spec for k, s in got.items()} == \
                    {k: tup(s.spec) for k, s in want.items()}


def test_multi_axis_dimension_is_sharded_in_mesh_order():
    """``("pod", "data")`` on one tensor dimension is Shard(d) on both mesh
    dimensions, pod first: DTensor splits d over pod, then each piece over
    data, JAX's major-to-minor order for ``P(("pod", "data"))``."""
    mesh = Mesh(torch.device("cpu"), {"pod": 2, "data": 4, "model": 2})
    r = shd.train_state_rules(mesh)
    assert shd._batch_axes(mesh) == ("pod", "data")
    assert r.spec(("d_model", "heads"), (64, 8)) == (("pod", "data"), "model")
    assert r.placements(("d_model", "heads"), (64, 8)) == (
        Shard(0), Shard(0), Shard(1))
    assert r.placements(("heads", "d_model"), (8, 64)) == (
        Shard(1), Shard(1), Shard(0))
    # a dimension that the pair does not divide is left whole
    assert r.spec(("d_model",), (12,)) == ()
    assert r.placements(("d_model",), (12,)) == (Replicate(),) * 3
    # which rows each (pod, data) coordinate holds, as JAX assigns them
    rows = np.arange(64)
    jmesh = jax.sharding.AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    want = R_shd.train_state_rules(jmesh).spec(("d_model", "heads"), (64, 8))
    assert tup(want) == (("pod", "data"), "model")
    for pod in range(2):
        for data in range(4):
            # DTensor: Shard(0) on pod, then Shard(0) on data of that piece
            piece = np.array_split(np.array_split(rows, 2)[pod], 4)[data]
            # JAX: the device's index along the flattened (pod, data) axis
            assert (piece == np.array_split(rows, 8)[pod * 4 + data]).all()


def test_spec_of_inverts_placements():
    mesh = Mesh(torch.device("cpu"), {"pod": 2, "data": 2, "model": 2})
    for spec in [(), ("data",), (None, "model"), (("pod", "data"), "model"),
                 ("model", None, ("pod", "data"))]:
        pl = shd.placements_of(mesh, spec)
        assert shd.spec_of(mesh, pl, max(len(spec), 1) + 1) == spec
    with pytest.raises(ValueError, match="twice"):
        shd.placements_of(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="not axes"):
        shd.placements_of(mesh, ("rows",))
