"""Parity of the port's MoE layer (``repro_torch.models.moe``) with the JAX
reference's ``repro/models/moe.py`` on the CPU: the reference's seeded
layer weights, copied into the port's ``MoE``, and the same seeded numpy
inputs go through both ``moe_block``s.

Tolerances (max abs error over max |reference|), as in
``test_torch_models.py``: float32 2e-5, bfloat16 5e-2.  A pair routed to
another expert, or kept where the reference drops it, would show as an
error of the order of the output itself."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import moe as R_moe

import repro_torch.configs as TC
from repro_torch.models import moe as T_moe

MOE = ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
T_TOKENS = (2, 12)  # (B, S): T = 24 tokens


def configs(arch, dtype="float32", **moe):
    """The reference's and the port's SMOKE config, with MoE fields set."""
    out = []
    for pkg in (RC, TC):
        cfg = pkg.get_config(arch, smoke=True).with_(dtype=dtype)
        out.append(cfg.with_(moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def layers(rcfg, tcfg, seed=3):
    """The reference's ``init_moe`` weights and the port's ``MoE`` holding
    them (copied through float32, which bfloat16 values survive)."""
    p, _ = R_moe.init_moe(rcfg, jax.random.key(seed))
    module = T_moe.MoE(tcfg, device="cpu")
    params = dict(module.named_parameters())
    leaves = jax.tree_util.tree_leaves_with_path(p)
    assert sorted(params) == sorted(
        ".".join(k.key for k in path) for path, _ in leaves)
    with torch.no_grad():
        for path, a in leaves:
            params[".".join(k.key for k in path)].copy_(
                torch.from_numpy(np.array(a.astype(jnp.float32))))
    return p, module


def inputs(cfg, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, T_TOKENS + (cfg.d_model,)).astype(np.float32)


def both(rcfg, tcfg, p, module, x):
    """(reference out, aux), (port out, aux) and the port's routing."""
    dt = tcfg.dtype
    ref = R_moe.moe_block(rcfg, p, jnp.asarray(x).astype(getattr(jnp, dt)))
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    with torch.no_grad():
        port = T_moe.moe_block(tcfg, module, xt)
        routing = T_moe.route(tcfg, module.router, xt.reshape(-1, x.shape[-1]))
    return ref, port, routing


def assert_close(ref, port, dtype="float32", what=""):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    port = port.detach().to(torch.float32).numpy()
    assert ref.shape == port.shape, (what, ref.shape, port.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - port).max())
    assert err <= TOL[dtype] * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_the_reference(arch, dtype):
    rcfg, tcfg = configs(arch, dtype)
    p, module = layers(rcfg, tcfg)
    assert module.router.dtype == torch.float32
    assert module.wi.dtype == getattr(torch, dtype)
    (rout, raux), (out, aux), _ = both(rcfg, tcfg, p, module, inputs(tcfg))
    assert out.dtype == getattr(torch, dtype)
    assert aux.dtype == torch.float32
    assert_close(rout, out, dtype, "out")
    assert_close(raux, aux, "float32", "aux")


@pytest.mark.parametrize("arch", MOE)
def test_forced_drops_match_the_reference(arch):
    """capacity_factor 0.5 at T = 24: C = 6 (phi, E 4) or 3 (deepseek,
    E 8) slots against 12 or 6 pairs per expert on average, so pairs are
    dropped; the outputs still agree."""
    rcfg, tcfg = configs(arch, capacity_factor=0.5)
    p, module = layers(rcfg, tcfg, seed=4)
    (rout, raux), (out, aux), r = both(rcfg, tcfg, p, module,
                                       inputs(tcfg, seed=1))
    T, k, E = 24, tcfg.moe.top_k, tcfg.moe.n_experts
    assert r.capacity == T_moe.capacity(tcfg, T) == max(
        int((T * k / E) * 0.5 + 0.5), k)
    dropped = int((~r.keep).sum())
    assert dropped > 0
    assert bool((r.slot[~r.keep] == E * r.capacity).all())
    kept = r.slot[r.keep]
    assert len(kept.unique()) == len(kept)  # one pair per kept slot
    assert_close(rout, out, what="out")
    assert_close(raux, aux, what="aux")


@pytest.mark.parametrize("arch", MOE)
def test_tie_rule_picks_the_lowest_experts(arch):
    """A zero router makes every probability 1/E: ``jax.lax.top_k`` picks
    experts 0..k-1 for every token, whose buffers overflow; the port picks
    the same and drops the same pairs."""
    rcfg, tcfg = configs(arch)
    p, module = layers(rcfg, tcfg, seed=5)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    with torch.no_grad():
        module.router.zero_()
    (rout, raux), (out, aux), r = both(rcfg, tcfg, p, module,
                                       inputs(tcfg, seed=2))
    k = tcfg.moe.top_k
    assert torch.equal(r.gate_idx, torch.arange(k).expand(24, k))
    assert int(r.keep.sum()) == k * r.capacity  # each of the k buffers full
    assert_close(rout, out, what="out")
    assert_close(raux, aux, what="aux")
