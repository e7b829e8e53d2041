"""The port's optimizer (``repro_torch.optim``) against the JAX reference:
the learning-rate schedule, AdamW given identical gradients, the train
state carried between the packages, and the int8 error-feedback
compression, on one rank and on 2 gloo ranks against the reference's
``compress_psum`` under ``shard_map`` on 2 forced host devices.

Tolerances, and why:
- AdamW: every leaf of params, m and v within 1e-6 x max |ref leaf|, and
  ``lr`` and ``grad_norm`` within 1e-6 relative.  The per-leaf arithmetic
  is the reference's, op for op, but the reference sums the squares of a
  stacked leaf (all layers) at once where the port sums each layer's, so
  the norm, and the clip scale with it, round differently;
- the schedule within 1e-6 relative (float32 ``cos`` of two libraries);
- the compression: the reduced gradients bitwise (elementwise float32
  arithmetic in one order, and integer sums); the error state within
  2^-23 x max |g32| per leaf, because XLA on the CPU contracts the
  reference's ``g32 - q * scale`` into one fused multiply-add, which rounds
  once where the port (``g32 - deq``, as the reference's code reads)
  rounds the product first: at most half an ulp of deq apart.
"""
import functools
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import repro.configs as RC
from repro.models import registry as R_reg
from repro.optim import adamw as R_opt
from repro.optim import compress as R_cmp

import repro_torch.configs as TC
from repro_torch.models.carry import (named_from_reference, reference_key,
                                      state_from_reference, state_to_numpy)
from repro_torch.optim import adamw as T_opt
from repro_torch.optim import compress as T_cmp

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-6
WORLD = 2
# a flat tree: the compression's scale is per leaf, so both packages must
# see the same leaves (a model's stacked leaves are per layer in the port)
LEAVES = {"a": (4, 8), "b": (16,), "c": (3, 5, 2), "d": (2, 64)}


def rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("opt", [R_opt.OptConfig(),
                                 R_opt.OptConfig(lr=1e-3, warmup_steps=5,
                                                 total_steps=100)])
def test_lr_schedule_matches_reference(opt):
    topt = T_opt.OptConfig(**opt.__dict__)
    for step in range(0, 12_000, 37):
        want = R_opt.lr_schedule(opt, jnp.asarray(step, jnp.int32))
        got = T_opt.lr_schedule(topt, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert rel(got, want) <= REL, (step, float(got), float(want))


def ref_state(arch):
    cfg = RC.get_config(arch, smoke=True)
    params, _ = R_reg.init_model(cfg, jax.random.key(11))
    return cfg, R_opt.init_state(params)


def grads_like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda t: (rng.normal(0, scale, t.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-7b",
                                  "whisper-medium"])
def test_adamw_matches_reference_given_identical_gradients(arch):
    """Three steps from one state: small gradients, then gradients whose
    norm is far above ``clip_norm`` (the clip scale acts), then small
    again.  deepseek holds dense-first and stacked expert leaves, zamba2
    the shared block and the SSM constants, whisper both stacks."""
    rcfg, rstate = ref_state(arch)
    tcfg = TC.get_config(arch, smoke=True)
    opt = R_opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    topt = T_opt.OptConfig(**opt.__dict__)
    tstate = state_from_reference(tcfg, jax.tree.map(np.asarray, rstate),
                                  device="cpu")
    ids = {k: id(t) for k, t in tstate.params.items()}
    upd = jax.jit(functools.partial(R_opt.apply_updates, opt))
    for i, scale in enumerate((1e-3, 10.0, 1e-3)):
        g = grads_like(rstate.params, seed=i, scale=scale)
        rstate, rm = upd(rstate, g)
        tstate, tm = T_opt.apply_updates(
            topt, tstate, named_from_reference(tcfg, g, device="cpu"))
        assert int(tstate.step) == int(rstate.step) == i + 1
        assert rel(tm["lr"], rm["lr"]) <= REL
        assert rel(tm["grad_norm"], rm["grad_norm"]) <= REL
        if scale > 1:
            assert float(tm["grad_norm"]) > 10 * opt.clip_norm
        got = state_to_numpy(tstate)
        for field in ("params", "m", "v"):
            want = jax.tree.map(np.asarray, getattr(rstate, field))
            for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
                node = got[field]
                for k in path:
                    node = node[k.key]
                err = float(np.abs(node - w).max())
                assert err <= REL * max(float(np.abs(w).max()), 1e-30), (
                    i, field, path, err)
    # the update wrote into the state's own tensors (the donated state)
    assert {k: id(t) for k, t in tstate.params.items()} == ids


def test_state_carry_and_leaf_order():
    """``state_from_reference`` / ``state_to_numpy`` round-trip the
    reference's state bitwise, and the port's leaves run in the
    reference's leaf order (sorted keys, a stacked leaf's layers in
    turn), the order ``global_norm`` adds them in."""
    rcfg, rstate = ref_state("deepseek-moe-16b")
    tcfg = TC.get_config("deepseek-moe-16b", smoke=True)
    ref_np = jax.tree.map(np.asarray, rstate)
    tstate = state_from_reference(tcfg, ref_np, device="cpu")
    back = state_to_numpy(tstate)
    assert int(back["step"]) == int(ref_np.step)
    for field in ("params", "m", "v"):
        want = getattr(ref_np, field)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(back[field])[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (_, w), (_, g) in zip(flat_w, flat_g):
            np.testing.assert_array_equal(w, g)
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref_np.params)[0]]
    runs = []
    for name in tstate.params:
        key = reference_key(name)[0]
        if not runs or runs[-1] != key:
            runs.append(key)
    assert runs == paths
    g = {k: torch.full_like(t, 0.5) for k, t in tstate.params.items()}
    want = np.sqrt(sum(np.sum(np.square(np.full(t.shape, 0.5, np.float32)))
                       for t in jax.tree.leaves(ref_np.params)))
    assert rel(T_opt.global_norm(g), want) <= REL


def test_init_state_orders_and_widens():
    params = {"z": torch.ones(2, dtype=torch.bfloat16),
              "blocks.1.w": torch.ones(3), "blocks.0.w": torch.zeros(3)}
    st = T_opt.init_state(params)
    assert list(st.params) == ["blocks.0.w", "blocks.1.w", "z"]
    assert all(t.dtype == torch.float32 for t in st.params.values())
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    st.params["z"].add_(1)
    assert float(params["z"][0]) == 1.0  # a copy, not a view


# -- compression ----------------------------------------------------------


def compress_inputs(world, seed=5):
    """Per rank: gradients, an error state and the reference's noise
    draws (``quantize_int8``'s ``jax.random.uniform`` under the keys
    ``compress_psum`` splits from the rank's key)."""
    rng = np.random.default_rng(seed)
    names = sorted(LEAVES)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), world))
    data = {}
    for r in range(world):
        sub = jax.random.split(keys[r], len(names))
        for i, k in enumerate(names):
            shape = LEAVES[k]
            data[f"g/{r}/{k}"] = rng.normal(0, 1e-2, shape).astype(np.float32)
            data[f"e/{r}/{k}"] = rng.normal(0, 1e-4, shape).astype(np.float32)
            data[f"n/{r}/{k}"] = np.asarray(jax.random.uniform(
                sub[i], shape, jnp.float32, -0.5, 0.5))
    return keys, data


def rank_tree(data, kind, r):
    return {k: data[f"{kind}/{r}/{k}"] for k in sorted(LEAVES)}


REF_CODE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim.compress import compress_psum

    data = np.load(sys.argv[1])
    keys = np.load(sys.argv[2])
    world = {world}
    names = sorted({{k.split("/")[2] for k in data.files}})
    stack = lambda kind: {{k: np.stack([data[f"{{kind}}/{{r}}/{{k}}"]
                                       for r in range(world)]) for k in names}}
    mesh = Mesh(np.array(jax.devices()[:world]), ("d",))

    def body(g, e, key):
        sq = lambda t: jax.tree.map(lambda x: x[0], t)
        out, err = compress_psum(sq(g), sq(e), key[0], "d")
        ex = lambda t: jax.tree.map(lambda x: x[None], t)
        return ex(out), ex(err)

    kw = dict(mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
              out_specs=(P("d"), P("d")))
    try:
        f = jax.shard_map(body, check_vma=False, **kw)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map
        f = shard_map(body, check_rep=False, **kw)
    out, err = jax.jit(f)(stack("g"), stack("e"), jnp.asarray(keys))
    np.savez(sys.argv[3], **{{f"out/{{r}}/{{k}}": np.asarray(out[k][r])
                             for k in names for r in range(world)}},
             **{{f"err/{{r}}/{{k}}": np.asarray(err[k][r])
                for k in names for r in range(world)}})
    print("DONE", flush=True)
""").format(world=WORLD)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multi_rank_runs(tmp_path_factory):
    """Both 2-rank runs, the reference's and the port's, started together
    on one set of inputs."""
    tmp = tmp_path_factory.mktemp("compress")
    keys, data = compress_inputs(WORLD)
    np.savez(tmp / "in.npz", **data)
    np.save(tmp / "keys.npy", keys)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    kw = dict(cwd=ROOT, env=env, stdout=subprocess.PIPE,
              stderr=subprocess.PIPE, text=True)
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, "-c", REF_CODE, str(tmp / "in.npz"),
             str(tmp / "keys.npy"), str(tmp / "ref.npz")], **kw),
        "port": subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_compress_worker.py"),
             str(_free_port()), str(WORLD), str(tmp / "in.npz"), str(tmp)],
            **kw),
    }
    for what, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0 and "DONE" in out, \
            f"{what} failed:\n{err[-3000:]}"
    return data, tmp


def test_compress_over_two_gloo_ranks_matches_reference_shard_map(
        multi_rank_runs):
    data, tmp = multi_rank_runs
    ref = np.load(tmp / "ref.npz")
    for r in range(WORLD):
        got = np.load(tmp / f"rank{r}.npz")
        for k in LEAVES:
            np.testing.assert_array_equal(got[f"out/{k}"], ref[f"out/{r}/{k}"],
                                          err_msg=f"out/{r}/{k}")
            g32 = data[f"g/{r}/{k}"] + data[f"e/{r}/{k}"]
            assert_err_close(got[f"err/{k}"], ref[f"err/{r}/{k}"], g32)
    # the ranks' sums really crossed: rank 0's output is not its own deq
    own = T_cmp.compress_with_noise(*(
        {k: torch.from_numpy(np.array(v))
         for k, v in rank_tree(data, kind, 0).items()} for kind in "gen"))
    got0 = np.load(tmp / "rank0.npz")
    assert not all(np.array_equal(own[0][k].numpy(), got0[f"out/{k}"])
                   for k in LEAVES)


def assert_err_close(got, want, g32):
    """The error states differ only by the reference's fused
    multiply-add (see the module docstring)."""
    err = float(np.abs(got - want).max())
    assert err <= 2.0 ** -23 * float(np.abs(g32).max()), err


@functools.cache
def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("d",))


def test_compress_one_rank_matches_reference():
    """With no group the world is one rank and no collective runs, as the
    reference's ``psum`` over an axis of size 1."""
    keys, data = compress_inputs(1, seed=9)
    g, e, n = (rank_tree(data, kind, 0) for kind in "gen")

    def body(g, e, key):
        return R_cmp.compress_psum(g, e, key, "d")

    kw = dict(mesh=one_device_mesh(), in_specs=(PartitionSpec(),) * 3,
              out_specs=(PartitionSpec(), PartitionSpec()))
    try:
        f = jax.shard_map(body, check_vma=False, **kw)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map
        f = shard_map(body, check_rep=False, **kw)
    r_out, r_err = jax.jit(f)(g, e, jnp.asarray(keys[0]))
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    out, err = T_cmp.compress_with_noise(t(g), t(e), t(n))
    for k in LEAVES:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(r_out[k]))
        assert_err_close(err[k].numpy(), np.asarray(r_err[k]), g[k] + e[k])


def test_compress_all_reduce_error_feedback_invariants():
    """At world size 1 with generator noise: the reduced gradient is deq,
    the new error state is exactly g32 - deq, and each element of deq
    lies within one scale step of g32; one generator seed gives one
    result."""
    rng = np.random.default_rng(2)
    grads = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
             for k, s in LEAVES.items()}
    err = T_cmp.init_error_state(grads)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        out, new_err = T_cmp.compress_all_reduce(grads, err, gen)
        for k, g in grads.items():
            g32 = g + err[k]
            scale = torch.clamp_min(g32.abs().max(), 1e-12) * (1.0 / 127.0)
            deq = out[k]
            assert torch.equal(new_err[k], g32 - deq)
            assert bool(((deq - g32).abs() <= scale).all())
        err = new_err
    a = T_cmp.compress_all_reduce(grads, err, torch.Generator().manual_seed(4))
    b = T_cmp.compress_all_reduce(grads, err, torch.Generator().manual_seed(4))
    for k in LEAVES:
        assert torch.equal(a[0][k], b[0][k])
