"""Parity of the port's selective state-space blocks
(``repro_torch.models.ssm``) with the JAX reference's ``repro/models/ssm.py``
on the CPU: the same seeded numpy inputs, and the reference's seeded layer
weights copied into the port's ``Mamba1``/``Mamba2``, go through both.

Tolerances (max abs error over max |reference|), as in
``test_torch_models.py``: float32 2e-5, bfloat16 5e-2.  ``_ssd_chunked``
does its intra-chunk math in bfloat16 in either config, so its output, and
a block or model that takes it (a Mamba-2 sequence that tiles into chunks
of ``SSD_CHUNK``), is held to the bfloat16 tolerance: the two packages
round the bfloat16 products at different points (XLA may keep a fused
chain in float32), and each rounding moves a value by up to 2^-8.  Its
float32 final state is compared within 2e-5 x max, the float32 state
recurrence being the same on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import registry as R_reg
from repro.models import ssm as R_ssm
from test_perf_paths import _ssd_inputs

import repro_torch.configs as TC
from repro_torch.models import registry as T_reg
from repro_torch.models import ssm as T_ssm
from repro_torch.models.carry import params_to_numpy

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
ARCH = {1: "falcon-mamba-7b", 2: "zamba2-7b"}
# the reference's trees (jax.eval_shape of init_model) and param_count()
SMOKE_TREE = {"falcon-mamba-7b": (126_912, 126_656),
              "zamba2-7b": (219_952, 221_680),
              "whisper-medium": (203_008, 201_472)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(ref, port, dtype="float32", what=""):
    ref, port = f32(ref), f32(port)
    assert ref.shape == port.shape, (what, ref.shape, port.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - port).max())
    assert err <= TOL[dtype] * scale, (what, err, scale)


def t(a):
    return torch.from_numpy(np.array(a))


def configs(version, dtype="float32"):
    return (RC.get_config(ARCH[version], smoke=True).with_(dtype=dtype),
            TC.get_config(ARCH[version], smoke=True).with_(dtype=dtype))


def layer(version, dtype="float32", seed=3):
    """The reference's ``init_mamba{1,2}`` weights and the port's mixer
    holding them (copied through float32, which bfloat16 values survive)."""
    rcfg, tcfg = configs(version, dtype)
    init = R_ssm.init_mamba1 if version == 1 else R_ssm.init_mamba2
    p, _ = init(rcfg, jax.random.key(seed))
    module = T_ssm.mixer(tcfg, device="cpu")
    params = dict(module.named_parameters())
    assert sorted(params) == sorted(p)
    with torch.no_grad():
        for k, v in p.items():
            params[k].copy_(t(v.astype(jnp.float32)))
    return rcfg, tcfg, p, module


def scan_inputs(seed, S, shape=(3, 4), a_shape=None):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (2, S) + (a_shape or shape)).astype(np.float32)
    b = rng.normal(0, 1, (2, S) + shape).astype(np.float32)
    return a, b


# -- the scan -------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_assoc_scan(S):
    """Odd and even lengths take both branches of the recursion.  The port
    repeats the reference's elementwise float32 operations in its order,
    so the scan is held bitwise."""
    a, b = scan_inputs(S, S)
    ref = R_ssm._assoc_scan(jnp.asarray(a), jnp.asarray(b))
    port = T_ssm._assoc_scan(t(a), t(b))
    # the same pairing and operand order: the same float32 operations
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
    # the first element is b_0 itself; the recurrence holds step by step
    np.testing.assert_array_equal(port[:, 0].numpy(), b[:, 0])
    h = b[:, 0]
    for i in range(1, S):
        h = a[:, i] * h + b[:, i]
    np.testing.assert_allclose(port[:, -1].numpy(), h, rtol=1e-5, atol=1e-5)


def test_assoc_scan_broadcast_decay():
    """Mamba-2's per-head decay: the port keeps ``a`` at (B, S, nh, 1, 1)
    where the reference broadcasts it to the state's shape."""
    a, b = scan_inputs(5, 13, shape=(3, 4, 5), a_shape=(3, 1, 1))
    ref = R_ssm._assoc_scan(jnp.broadcast_to(jnp.asarray(a), b.shape),
                            jnp.asarray(b))
    assert_close(ref, T_ssm._assoc_scan(t(a), t(b)))


@pytest.mark.parametrize("S", [300, 1024])
def test_chunked_assoc_scan_with_h0(S):
    """One scan with h0 folded into b[:, 0] (S <= 512), and two chunks of
    512 in sequence (S = 1024)."""
    a, b = scan_inputs(6, S)
    h0 = np.random.default_rng(7).normal(0, 1, (2, 3, 4)).astype(np.float32)
    for init in (None, h0):
        rh, rl = R_ssm._chunked_assoc_scan(
            jnp.asarray(a), jnp.asarray(b),
            None if init is None else jnp.asarray(init))
        ph, pl = T_ssm._chunked_assoc_scan(t(a), t(b),
                                           None if init is None else t(init))
        assert_close(rh, ph, what=("h", S))
        assert_close(rl, pl, what=("last", S))


def test_chunked_assoc_scan_rejects_what_the_reference_asserts():
    """S = 600 > 512 is not a multiple of the chunk: the reference's
    assertion fails, and the port raises rather than pad."""
    a, b = scan_inputs(8, 600)
    with pytest.raises(AssertionError):
        R_ssm._chunked_assoc_scan(jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError, match="multiple"):
        T_ssm._chunked_assoc_scan(t(a), t(b))


@pytest.mark.parametrize("S", [2, 9])
def test_causal_conv(S):
    """Without a state (zero padding; S = 2 is shorter than K - 1, so the
    returned state keeps padding) and continuing from one."""
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (2, S, 6)).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 6)).astype(np.float32)
    b = rng.normal(0, 0.1, 6).astype(np.float32)
    st = rng.normal(0, 1, (2, 3, 6)).astype(np.float32)
    for state in (None, st):
        ry, rs = R_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if state is None else jnp.asarray(state))
        py, ps = T_ssm._causal_conv(t(x), t(w), t(b),
                                    None if state is None else t(state))
        assert_close(ry, py)
        np.testing.assert_array_equal(np.asarray(rs), ps.numpy())


# -- the SSD --------------------------------------------------------------


@pytest.mark.parametrize("seed,Q", [(0, 8), (1, 16), (2, 32)])
def test_ssd_chunked(seed, Q):
    """``tests/test_perf_paths.py``'s inputs (S = 64), with and without an
    initial state."""
    dt, A, xh, Bc, Cc, h0 = _ssd_inputs(seed)
    for init in (None, h0):
        ry, rl = R_ssm._ssd_chunked(dt, A, xh, Bc, Cc, init, Q)
        py, pl = T_ssm._ssd_chunked(
            t(dt), t(A), t(xh), t(Bc), t(Cc),
            None if init is None else t(init), Q)
        assert py.dtype == torch.bfloat16 and pl.dtype == torch.float32
        assert_close(ry, py, "bfloat16", what=("y", Q))
        assert_close(rl, pl, what=("last", Q))


# -- the blocks -----------------------------------------------------------


def block_inputs(cfg, S, seed=11, B=2):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def state_inputs(rcfg, version, B=2, seed=12):
    init = R_ssm.mamba1_state_init if version == 1 else R_ssm.mamba2_state_init
    st = init(rcfg, B, jnp.float32)
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
            for k, v in st.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version,S", [(1, 12), (2, 64), (2, 512)])
def test_block(version, S, dtype):
    """Mamba-1, Mamba-2 naive (S = 64) and chunked (S = 512: 2 chunks of
    256), from zero and from a carried state: output and final states."""
    rcfg, tcfg, p, module = layer(version, dtype)
    fwd = R_ssm.mamba1_block if version == 1 else R_ssm.mamba2_block
    x = block_inputs(rcfg, S)
    st = state_inputs(rcfg, version)
    rdt = getattr(jnp, dtype)
    tol = "bfloat16" if (version == 2 and S == 512) else dtype
    for state in (None, st):
        ry, rs = fwd(rcfg, p, jnp.asarray(x).astype(rdt), state=None if
                     state is None else jax.tree.map(jnp.asarray, state))
        with torch.no_grad():
            py, ps = module(t(x).to(getattr(torch, dtype)), None if state is
                            None else {k: t(v) for k, v in state.items()})
        assert py.dtype == getattr(torch, dtype)
        assert_close(ry, py, tol, what="y")
        assert_close(rs["conv"], ps["conv"], dtype, what="conv")
        assert ps["ssm"].dtype == torch.float32
        assert_close(rs["ssm"], ps["ssm"],
                     "float32" if dtype == "float32" else "bfloat16",
                     what="ssm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [1, 2])
def test_decode(version, dtype):
    """Four single-token steps from a carried float32 state (the engine's
    cache): the conv state's promotion and the states after each step."""
    rcfg, tcfg, p, module = layer(version, dtype)
    dec = R_ssm.mamba1_decode if version == 1 else R_ssm.mamba2_decode
    tdec = T_ssm.decode_fn(tcfg)
    st = state_inputs(rcfg, version)
    rs = jax.tree.map(jnp.asarray, st)
    ps = {k: t(v) for k, v in st.items()}
    rng = np.random.default_rng(13)
    for i in range(4):
        x = rng.normal(0, 1, (2, 1, rcfg.d_model)).astype(np.float32)
        ry, rs = dec(rcfg, p, jnp.asarray(x).astype(getattr(jnp, dtype)), rs)
        with torch.no_grad():
            py, ps = tdec(tcfg, module, t(x).to(getattr(torch, dtype)), ps)
        assert py.dtype == getattr(torch, dtype)  # the residual's dtype
        assert_close(ry, py, dtype, what=("y", i))
        for k in ("conv", "ssm"):
            assert ps[k].dtype == torch.float32
            assert_close(rs[k], ps[k], dtype, what=(k, i))


def test_decode_continues_the_block():
    """Mamba-2 prefill of 7 tokens then 3 decode steps equals the block
    over all 10 (the port against itself, through its own states)."""
    _, tcfg, _, module = layer(2)
    x = t(block_inputs(tcfg, 10, seed=14))
    with torch.no_grad():
        full, _ = module(x)
        _, st = module(x[:, :7])
        outs = []
        for i in range(7, 10):
            y, st = T_ssm.mamba2_decode(tcfg, module, x[:, i:i + 1], st)
            outs.append(y)
    assert_close(full[:, 7:], torch.cat(outs, 1))


# -- init -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_init_constants_and_scales(arch, dtype):
    """``init_model``'s constant leaves equal the reference's bitwise
    (``A_log`` and ``D`` float32 in either config); every drawn leaf is a
    [-2, 2]-truncated normal at the reference's scale (std = scale x 0.88):
    ``conv_w`` at 0.3, ``embed`` at 0.02, the rest at d_in ** -0.5."""
    rcfg = RC.get_config(arch, smoke=True).with_(dtype=dtype)
    tcfg = TC.get_config(arch, smoke=True).with_(dtype=dtype)
    params, _ = R_reg.init_model(rcfg, jax.random.key(0))
    model = T_reg.init_model(tcfg, torch.Generator().manual_seed(5),
                             device="cpu")
    ref = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    port = params_to_numpy(model)
    assert jax.tree.structure(ref) == jax.tree.structure(port)
    constants = ("conv_b", "dt_bias", "A_log", "D", "norm_w", "w", "b")
    drawn = 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(port)):
        leaf = path[-1].key
        assert a.shape == b.shape, path
        if leaf in constants:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            continue
        stacked = path[0].key == "blocks"
        d_in = a.shape[-2]
        scale = {"embed": 0.02, "conv_w": 0.3}.get(leaf, d_in ** -0.5)
        for m in (b if stacked else b[None]):
            assert abs(m.std() / (0.88 * scale) - 1) < 0.15, (path, m.std())
            assert np.abs(m).max() <= 2 * scale * 1.01, path
        drawn += 1
    assert drawn >= 5
    for name, p in model.named_parameters():
        if name.endswith(("A_log", ".D")) or (
                arch == "zamba2-7b" and name.endswith("dt_bias")):
            assert p.dtype == torch.float32, name
        else:
            assert p.dtype == getattr(torch, dtype), name


@pytest.mark.parametrize("arch", list(SMOKE_TREE))
def test_parameter_count_equals_the_reference_tree(arch):
    """The port's model holds as many elements as the reference's tree;
    ``ModelConfig.param_count()`` only estimates these families."""
    rcfg = RC.get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda k: R_reg.init_model(rcfg, k)[0],
                            jax.random.key(0))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = T_reg.init_model(TC.get_config(arch, smoke=True),
                             torch.Generator().manual_seed(0), device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert (n_ref, rcfg.param_count()) == SMOKE_TREE[arch]
    assert n == n_ref
