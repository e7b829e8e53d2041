"""Parity of the port's model side (``repro_torch.models``, ``configs``)
with the JAX reference: the same seeded weights, carried across by
``params_from_reference``, and the same seeded numpy inputs go through both
packages on the CPU.

Tolerances (max abs error over max |reference|): float32 2e-5, bfloat16
5e-2.  Both packages compute the same arithmetic in the same dtypes, but
their CPU kernels sum in different orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import attention as R_attn
from repro.models import common as R_common
from repro.models import mlp as R_mlp
from repro.models import registry as R_reg
from repro.models import transformer as R_lm
from repro.models.config import ShapeConfig as R_Shape

import repro_torch.configs as TC
from repro_torch.models import attention as T_attn
from repro_torch.models import common as T_common
from repro_torch.models import registry as T_reg
from repro_torch.models import transformer as T_lm
from repro_torch.models.carry import params_from_reference, params_to_numpy
from repro_torch.models.config import ShapeConfig as T_Shape
from repro_torch.models.mlp import MLP

DENSE = ["qwen2-0.5b", "llama3.2-1b", "qwen2.5-14b", "stablelm-3b",
         "internvl2-2b"]
# deepseek's SMOKE keeps its dense-first layer: layer 0 dense, 1-2 MoE
MOE = ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"]
SSM = ["falcon-mamba-7b", "zamba2-7b"]
# zamba2's SMOKE (4 layers, attn_every 2) has no tail group; 5 layers do
HYBRID_TAIL = dict(n_layers=5)
TOL = {"float32": 2e-5, "bfloat16": 5e-2}

_MODELS: dict = {}
# one compile per shape for the reference's decode loop
R_decode = jax.jit(R_lm.lm_decode_step, static_argnums=0)


def models(arch, dtype="float32", **fields):
    """(reference cfg, reference params, port cfg, port model), cached;
    ``fields`` override the SMOKE config's."""
    key = (arch, dtype, tuple(sorted(fields.items())))
    if key not in _MODELS:
        rcfg = RC.get_config(arch, smoke=True).with_(dtype=dtype, **fields)
        tcfg = TC.get_config(arch, smoke=True).with_(dtype=dtype, **fields)
        params, _ = R_reg.init_model(rcfg, jax.random.key(7))
        tree = jax.tree.map(np.asarray, params)
        _MODELS[key] = (rcfg, params, tcfg,
                        params_from_reference(tcfg, tree, device="cpu"))
    return _MODELS[key]


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


def tokens(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


# -- configs --------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_config_fields_and_counts_equal(arch):
    for smoke in (False, True):
        r, t = RC.get_config(arch, smoke), TC.get_config(arch, smoke)
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
        assert r.param_count() == t.param_count()
        assert r.active_param_count() == t.active_param_count()
        assert r.hd() == t.hd()
    assert RC.train_accumulation(arch) == TC.train_accumulation(arch)
    assert RC.train_mode(arch) == TC.train_mode(arch)


def test_registry_tables_equal():
    from repro.models.config import SHAPES as RS
    from repro_torch.models.config import SHAPES as TS
    assert RC.ARCHS == TC.ARCHS
    assert RC.LONG_CONTEXT_OK == TC.LONG_CONTEXT_OK
    assert RC.cells() == TC.cells()
    assert RC.cells(include_skipped=True) == TC.cells(include_skipped=True)
    assert {k: dataclasses.asdict(v) for k, v in RS.items()} == \
        {k: dataclasses.asdict(v) for k, v in TS.items()}
    with pytest.raises(KeyError):
        TC.get_config("gpt-5")


# -- shared layers --------------------------------------------------------


def test_rope_norms_positions_and_loss():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 40_000, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(R_common.rope_angles(64, 1e6, jnp.asarray(pos))),
        T_common.rope_angles(64, 1e6, torch.from_numpy(pos)).numpy())
    x = rng.normal(0, 1, (3, 7, 4, 64)).astype(np.float32)
    assert_close(R_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
                 T_common.apply_rope(torch.from_numpy(x),
                                     torch.from_numpy(pos), 1e6))
    np.testing.assert_array_equal(
        np.asarray(R_common.sinusoidal_positions(33, 16)),
        T_common.sinusoidal_positions(33, 16).numpy())
    h = rng.normal(0, 2, (5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        rj = lambda a: jnp.asarray(a).astype(getattr(jnp, dt))  # noqa: E731
        tt = lambda a: torch.from_numpy(a).to(T_common.dtype_of(dt))  # noqa: E731
        assert_close(R_common.rms_norm(rj(h), rj(w), 1e-5),
                     T_common.rms_norm(tt(h), tt(w), 1e-5), dt)
        assert_close(R_common.layer_norm(rj(h), rj(w), rj(b), 1e-5),
                     T_common.layer_norm(tt(h), tt(w), tt(b), 1e-5), dt)
    logits = rng.normal(0, 3, (4, 6, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) < 0.7).astype(np.float32)
    for m in (None, mask):
        ref = R_common.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        port = T_common.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert_close(ref, port)


def test_gelu_mlp_and_cross_attention():
    rcfg = RC.get_config("whisper-medium", smoke=True)
    tcfg = TC.get_config("whisper-medium", smoke=True)
    rng = np.random.default_rng(2)
    p, _ = R_mlp.init_mlp(rcfg, jax.random.key(3))
    p = dict(p, bi=jnp.asarray(rng.normal(0, 0.1, p["bi"].shape), jnp.float32),
             bo=jnp.asarray(rng.normal(0, 0.1, p["bo"].shape), jnp.float32))
    m = MLP(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(torch.from_numpy(np.array(v)))
    x = rng.normal(0, 1, (2, 5, tcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        assert_close(R_mlp.mlp(rcfg, p, jnp.asarray(x)),
                     m(torch.from_numpy(x)))
    # cross attention (xkv), not causal, as the enc-dec decoder calls it
    ap, _ = R_attn.init_attention(rcfg, jax.random.key(4))
    a = T_attn.Attention(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in ap.items():
            getattr(a, k).copy_(torch.from_numpy(np.array(v)))
    xkv = rng.normal(0, 1, (2, 9, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    ref, (rk, rv) = R_attn.attention(rcfg, ap, jnp.asarray(x),
                                     jnp.asarray(pos), causal=False,
                                     xkv=jnp.asarray(xkv))
    with torch.no_grad():
        out, (k, v) = a(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                        causal=False, xkv=torch.from_numpy(xkv))
    assert_close(ref, out)
    assert_close(rk, k)
    assert_close(rv, v)


def test_chunk_shapes_the_reference_rejects_raise():
    """Sq = 25 at q_chunk = 8 makes 3 chunks of 8: the reference's reshape
    fails, and the port raises rather than pad."""
    rcfg, params, tcfg, model = models("llama3.2-1b")
    tok = tokens(rcfg, S=25)
    with pytest.raises(TypeError):
        R_lm.lm_forward(rcfg, params, tok, q_chunk=8, kv_chunk=8, remat=False)
    with pytest.raises(ValueError, match="does not split"):
        T_lm.lm_forward(tcfg, model, torch.from_numpy(tok), q_chunk=8,
                        kv_chunk=8)


# -- carrying weights -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_round_trip(dtype):
    _, params, _, model = models("qwen2-0.5b", dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    back = params_to_numpy(model)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_init_model_layout_and_seeding():
    """The port draws its own weights (JAX's random stream is not
    reproduced): the reference's tree layout, shapes and scales, and the
    same weights from the same generator seed."""
    for arch in DENSE:
        rcfg = RC.get_config(arch, smoke=True)
        tcfg = TC.get_config(arch, smoke=True)
        params, _ = R_reg.init_model(rcfg, jax.random.key(0))
        model = T_reg.init_model(tcfg, torch.Generator().manual_seed(5),
                                 device="cpu")
        tree = params_to_numpy(model)
        ref = jax.tree.map(np.asarray, params)
        assert jax.tree.structure(ref) == jax.tree.structure(tree), arch
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree.leaves(tree)):
            assert a.shape == b.shape, (arch, path)
            if a.ndim >= 2 and a.size >= 4096:  # draws: same scale
                assert abs(b.std() / a.std() - 1) < 0.1, (arch, path)
            elif a.ndim == 1 or (a.ndim == 2 and "blocks" in str(path)):
                np.testing.assert_array_equal(a, b)  # ones / zeros
        again = T_reg.init_model(tcfg, torch.Generator().manual_seed(5),
                                 device="cpu")
        for x, y in zip(model.parameters(), again.parameters()):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_carry_round_trip_moe(arch, dtype):
    """The stacked (L, E, ...) expert weights, the router and deepseek's
    ``dense_blocks`` cross and come back bitwise; the router stays float32
    in a bfloat16 config."""
    rcfg, params, _, model = models(arch, dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    back = params_to_numpy(model)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert ("dense_blocks" in back) == bool(rcfg.moe.first_dense_layers)
    for blk in model.blocks:
        assert blk.moe.router.dtype == torch.float32
        assert blk.moe.wi.dtype == getattr(torch, dtype)
    assert sum(p.numel() for p in model.parameters()) == rcfg.param_count()


@pytest.mark.parametrize("arch", MOE)
def test_init_model_draws_every_moe_parameter(arch):
    """Every matrix drawn (none left at ``torch.empty``'s values): each
    expert tensor, the router and the dense-first layer at the reference's
    scale (std = scale x 0.88, the [-2, 2] truncated normal's), vectors
    ones or zeros; the router float32 in a bfloat16 config; the same
    weights from the same seed."""
    rcfg = RC.get_config(arch, smoke=True)
    tcfg = TC.get_config(arch, smoke=True).with_(dtype="bfloat16")
    params, _ = R_reg.init_model(rcfg, jax.random.key(0))
    model = T_reg.init_model(tcfg, torch.Generator().manual_seed(5),
                             device="cpu")
    tree = params_to_numpy(model)
    ref = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(ref) == jax.tree.structure(tree)
    m = tcfg.moe
    for name, p in model.named_parameters():
        a = p.detach().to(torch.float32)
        if p.ndim == 1:
            assert torch.equal(a, torch.ones_like(a)) or not a.any(), name
            continue
        if name.endswith("router"):
            assert p.dtype == torch.float32, name
        else:
            assert p.dtype == torch.bfloat16, name
        if name == "embed":
            scale = 0.02
        elif name.endswith("moe.wo"):
            scale = m.d_ff_expert ** -0.5
        else:
            scale = p.shape[-2] ** -0.5
        assert abs(float(a.std()) / (0.88 * scale) - 1) < 0.1, name
        assert float(a.abs().max()) <= 2 * scale * 1.01, name
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(tree)):
        assert a.shape == b.shape, path
    again = T_reg.init_model(tcfg, torch.Generator().manual_seed(5),
                             device="cpu")
    for x, y in zip(model.parameters(), again.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM + ["whisper-medium"])
def test_carry_round_trip_ssm_hybrid_encdec(arch, dtype):
    """The SSM blocks with their float32 ``A_log`` and ``D``, the hybrid's
    unstacked ``shared_attn`` and the enc-dec's stacked ``enc_blocks`` and
    ``dec_blocks`` cross and come back bitwise."""
    rcfg, params, _, model = models(arch, dtype)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    back = params_to_numpy(model)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    for name, p in model.named_parameters():  # each leaf keeps its dtype
        ref = params
        for k in name.split("."):
            ref = ref if k.isdigit() else ref[k]  # a layer of a stack
        assert str(p.dtype).split(".")[1] == str(ref.dtype), name
    assert ("shared_attn" in back) == (rcfg.family == "hybrid")


def test_lm_refuses_enc_dec():
    """The enc-dec family is ``encdec.py``'s: ``LM`` and its cache refuse
    it, and ``init_model`` builds an ``EncDec``."""
    tcfg = TC.get_config("whisper-medium", smoke=True)
    with pytest.raises(ValueError, match="encdec"):
        T_lm.LM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        T_lm.init_lm_cache(tcfg, 1, 8, torch.float32, device="cpu")
    model = T_reg.init_model(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert type(model).__name__ == "EncDec"


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-2b",
                                  "whisper-medium"])
def test_batch_shapes_and_make_batch(arch):
    rcfg, tcfg = RC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    for kind in ("train", "prefill", "decode"):
        rs, ts = R_Shape("t", kind, 32, 2), T_Shape("t", kind, 32, 2)
        for masked in (False, True):
            ref = R_reg.batch_shapes(rcfg, rs, masked=masked)
            port = T_reg.batch_shapes(tcfg, ts, masked=masked)
            assert list(ref) == list(port)
            for k in ref:
                assert ref[k][0] == port[k][0], (kind, k)
                assert str(jnp.dtype(ref[k][1])) == str(port[k][1]).split(".")[1]
        ref = R_reg.make_batch(rcfg, rs, seed=3)
        port = T_reg.make_batch(tcfg, ts, seed=3, device="cpu")
        assert list(ref) == list(port)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ref[k]), port[k].numpy())


# -- the forward pass -----------------------------------------------------


@pytest.mark.parametrize("mode", ["all", "last", "none"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_float32(arch, mode):
    rcfg, params, tcfg, model = models(arch)
    tok = tokens(rcfg)
    ref, raux = R_lm.lm_forward(rcfg, params, tok, logits_mode=mode,
                                remat=False)
    with torch.no_grad():
        out, aux = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok),
                                   logits_mode=mode)
    assert_close(ref, out, what=mode)
    assert float(raux) == float(aux) == 0.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-3b"])
def test_lm_forward_multichunk(arch):
    """S = 24 in chunks of 8 on both axes: 3 query chunks, each over 3 KV
    chunks of the online softmax (two of them fully masked for the first
    query chunk)."""
    rcfg, params, tcfg, model = models(arch)
    tok = tokens(rcfg, S=24, seed=4)
    ref, _ = R_lm.lm_forward(rcfg, params, tok, q_chunk=8, kv_chunk=8,
                             remat=False)
    with torch.no_grad():
        out, _ = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok),
                                 q_chunk=8, kv_chunk=8)
        one, _ = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok))
    assert_close(ref, out)
    assert_close(one, out)


@pytest.mark.parametrize("mode", ["all", "last"])
def test_vlm_patch_embeds(mode):
    rcfg, params, tcfg, model = models("internvl2-2b")
    rng = np.random.default_rng(5)
    pe = rng.normal(0, 0.02, (2, rcfg.n_img_tokens, rcfg.d_model)).astype(
        np.float32)
    tok = tokens(rcfg, S=8, seed=6)
    ref, _ = R_lm.lm_forward(rcfg, params, tok, patch_embeds=jnp.asarray(pe),
                             logits_mode=mode, q_chunk=4, kv_chunk=4,
                             remat=False)
    with torch.no_grad():
        out, _ = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok),
                                 patch_embeds=torch.from_numpy(pe),
                                 logits_mode=mode, q_chunk=4, kv_chunk=4)
    assert out.shape[1] == (16 if mode == "all" else 1)
    assert_close(ref, out)


@pytest.mark.parametrize("mode", ["all", "last", "none"])
@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_moe_logits_and_aux(arch, mode):
    """Logits (or hidden states) and the MoE layers' summed aux loss."""
    rcfg, params, tcfg, model = models(arch)
    tok = tokens(rcfg, seed=14)
    ref, raux = R_lm.lm_forward(rcfg, params, tok, logits_mode=mode,
                                remat=False)
    with torch.no_grad():
        out, aux = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok),
                                   logits_mode=mode)
    assert_close(ref, out, what=mode)
    assert float(raux) > 0
    assert_close(raux, aux, what="aux")


@pytest.mark.parametrize("arch", MOE)
def test_lm_forward_moe_bfloat16(arch):
    """bfloat16 rounds each layer's input to about 2^-8, so a token whose
    k-th and (k+1)-th router probabilities lie that close can go to either
    expert in either package, and its output then differs by its own
    size.  Zero routers make every probability 1/E in any precision: the
    tie rule routes every token to experts 0..k-1, whose buffers overflow,
    and the rest of the bfloat16 model (dense-first layer, attention,
    experts, drops, shared experts) is compared without that ambiguity.
    With the drawn routers, bfloat16 is held at the layer level
    (``tests/test_torch_moe.py``, the same inputs on both sides)."""
    rcfg, params, tcfg, _ = models(arch, "bfloat16")
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.zeros_like(a) if path[-1].key == "router" else a,
        params)
    model = params_from_reference(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    tok = tokens(rcfg, seed=15)
    ref, raux = R_lm.lm_forward(rcfg, params, tok, remat=False)
    with torch.no_grad():
        out, aux = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok))
    assert out.dtype == torch.bfloat16
    assert_close(ref, out, "bfloat16")
    assert_close(raux, aux, "bfloat16", "aux")


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_bfloat16(arch):
    rcfg, params, tcfg, model = models(arch, "bfloat16")
    tok = tokens(rcfg, seed=8)
    ref, _ = R_lm.lm_forward(rcfg, params, tok, remat=False)
    with torch.no_grad():
        out, _ = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok))
    assert out.dtype == torch.bfloat16
    assert_close(ref, out, "bfloat16")


# -- prefill and decode ---------------------------------------------------


SSM_CASES = [("falcon-mamba-7b", {}), ("zamba2-7b", {}),
             ("zamba2-7b", HYBRID_TAIL)]


def _case_id(case):
    arch, fields = case
    return arch + ("-L5" if fields else "")


@pytest.mark.parametrize("mode", ["all", "last", "none"])
@pytest.mark.parametrize("case", SSM_CASES, ids=_case_id)
def test_lm_forward_ssm_hybrid(case, mode):
    """falcon-mamba (mamba1 blocks) and zamba2 (mamba2 blocks and the
    shared block after the first of each group): SMOKE, and 5 layers,
    whose tail group calls the shared block a third time."""
    arch, fields = case
    rcfg, params, tcfg, model = models(arch, **fields)
    tok = tokens(rcfg, seed=16)
    ref, raux = R_lm.lm_forward(rcfg, params, tok, logits_mode=mode,
                                remat=False)
    with torch.no_grad():
        out, aux = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok),
                                   logits_mode=mode)
    assert_close(ref, out, what=mode)
    assert float(raux) == float(aux) == 0.0


@pytest.mark.parametrize("case", [("falcon-mamba-7b", dict(n_layers=1)),
                                  ("zamba2-7b", dict(n_layers=2))],
                         ids=_case_id)
def test_lm_forward_ssm_long_sequences(case):
    """S = 1024: the Mamba-1 scan in two chunks of 512; the Mamba-2 block's
    chunked SSD (4 chunks of 256, bfloat16 inside a chunk, hence the
    bfloat16 tolerance; see ``tests/test_torch_ssm.py``)."""
    arch, fields = case
    rcfg, params, tcfg, model = models(arch, **fields)
    tok = tokens(rcfg, B=1, S=1024, seed=17)
    ref, _ = R_lm.lm_forward(rcfg, params, tok, remat=False)
    with torch.no_grad():
        out, _ = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok))
    assert_close(ref, out, "bfloat16" if rcfg.family == "hybrid"
                 else "float32")


@pytest.mark.parametrize("arch", SSM)
def test_lm_forward_ssm_bfloat16(arch):
    rcfg, params, tcfg, model = models(arch, "bfloat16")
    tok = tokens(rcfg, seed=18)
    ref, _ = R_lm.lm_forward(rcfg, params, tok, remat=False)
    with torch.no_grad():
        out, _ = T_lm.lm_forward(tcfg, model, torch.from_numpy(tok))
    assert out.dtype == torch.bfloat16
    assert_close(ref, out, "bfloat16")


def assert_caches_close(rc, tc, tol="float32", what=""):
    """Every leaf of the port's cache has the reference's dtype and values
    within the tolerance ``tol``."""
    for group, leaves in tc.items():
        for k, v in leaves.items():
            assert str(v.dtype).split(".")[1] == str(rc[group][k].dtype), \
                (what, group, k)
            assert_close(rc[group][k], v, tol, what=(what, group, k))


@pytest.mark.parametrize("pos", ["scalar", "per_slot"])
@pytest.mark.parametrize("case", SSM_CASES, ids=_case_id)
def test_lm_prefill_and_decode_ssm_hybrid(case, pos):
    """lm_prefill into the whole cache (the SSM states cast to its dtype,
    the hybrid's k/v per call site), then 4 decode steps; the logits and
    every cache leaf after each."""
    arch, fields = case
    rcfg, params, tcfg, model = models(arch, **fields)
    B, S, max_len = 3, 9, 24
    prompt = tokens(rcfg, B=B, S=S, seed=19)
    rc, _ = R_lm.init_lm_cache(rcfg, B, max_len, jnp.float32)
    ref, rc = R_lm.lm_prefill(rcfg, params, prompt, rc)
    tc = T_lm.init_lm_cache(tcfg, B, max_len, torch.float32, device="cpu")
    out, tc = T_lm.lm_prefill(tcfg, model, torch.from_numpy(prompt), tc)
    assert sorted(tc) == sorted(rc)
    assert_close(ref, out, what="prefill")
    assert_caches_close(rc, tc, what="prefill")
    rng = np.random.default_rng(20)
    for i in range(4):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        p = (np.int32(S + i) if pos == "scalar"
             else np.array([S + i, 3 + 2 * i, 1], np.int32))
        ref, rc = R_decode(rcfg, params, tok, rc, jnp.asarray(p))
        out, tc = T_lm.lm_decode_step(tcfg, model, torch.from_numpy(tok), tc,
                                      torch.from_numpy(np.asarray(p)))
        assert_close(ref, out, what=f"step {i}")
        assert_caches_close(rc, tc, what=f"step {i}")


def test_ssm_decode_over_a_float32_cache_in_bfloat16():
    """The reference's Mamba decode keeps the residual in the model's dtype
    over float32 states (the conv state promotes, the block's output is
    cast back): a bfloat16 falcon-mamba decodes against the engine's
    float32 cache in both packages."""
    rcfg, params, tcfg, model = models("falcon-mamba-7b", "bfloat16")
    tok = tokens(rcfg, B=2, S=5, seed=21)
    rc, _ = R_lm.init_lm_cache(rcfg, 2, 8, jnp.float32)
    _, rc = R_lm.lm_prefill(rcfg, params, tok, rc)
    tc = T_lm.init_lm_cache(tcfg, 2, 8, torch.float32, device="cpu")
    T_lm.lm_prefill(tcfg, model, torch.from_numpy(tok), tc)
    for i in range(3):
        step = tok[:, i:i + 1]
        ref, rc = R_lm.lm_decode_step(rcfg, params, step, rc, jnp.int32(5 + i))
        out, tc = T_lm.lm_decode_step(tcfg, model, torch.from_numpy(step),
                                      tc, 5 + i)
        assert out.dtype == torch.bfloat16
        assert_close(ref, out, "bfloat16", what=i)
        # float32 states of a bfloat16 model's values
        assert_caches_close(rc, tc, "bfloat16", what=i)


def test_hybrid_bf16_over_f32_cache_fails_in_both():
    """zamba2's shared block decodes attention against the float32 cache,
    which promotes the residual: the reference's group scan rejects the
    carry, and the port raises too."""
    rcfg, params, tcfg, model = models("zamba2-7b", "bfloat16")
    tok = tokens(rcfg, B=2, S=1)
    rc, _ = R_lm.init_lm_cache(rcfg, 2, 8, jnp.float32)
    with pytest.raises(TypeError, match="carry"):
        R_lm.lm_decode_step(rcfg, params, tok, rc, jnp.int32(0))
    tc = T_lm.init_lm_cache(tcfg, 2, 8, torch.float32, device="cpu")
    with pytest.raises(TypeError, match="carry"):
        T_lm.lm_decode_step(tcfg, model, torch.from_numpy(tok), tc, 0)
    # over a bfloat16 cache both decode
    rc, _ = R_lm.init_lm_cache(rcfg, 2, 8, jnp.bfloat16)
    ref, _ = R_lm.lm_decode_step(rcfg, params, tok, rc, jnp.int32(0))
    tc = T_lm.init_lm_cache(tcfg, 2, 8, torch.bfloat16, device="cpu")
    out, _ = T_lm.lm_decode_step(tcfg, model, torch.from_numpy(tok), tc, 0)
    assert_close(ref, out, "bfloat16")




@pytest.mark.parametrize("arch", DENSE + MOE)
def test_lm_prefill_logits_and_cache(arch):
    rcfg, params, tcfg, model = models(arch)
    tok = tokens(rcfg, S=10, seed=9)
    kw = {}
    pe = None
    if rcfg.family == "vlm":
        pe = np.random.default_rng(10).normal(
            0, 0.02, (2, rcfg.n_img_tokens, rcfg.d_model)).astype(np.float32)
        kw = dict(patch_embeds=jnp.asarray(pe))
    rc, _ = R_lm.init_lm_cache(rcfg, 2, 32, jnp.float32)
    ref, rc = R_lm.lm_prefill(rcfg, params, tok, rc, **kw)
    tc = T_lm.init_lm_cache(tcfg, 2, 32, torch.float32, device="cpu")
    out, tc = T_lm.lm_prefill(
        tcfg, model, torch.from_numpy(tok), tc,
        patch_embeds=None if pe is None else torch.from_numpy(pe))
    assert_close(ref, out)
    for k in ("k", "v"):
        assert_close(rc["attn"][k], tc["attn"][k], what=k)


def _decode_both(arch, pos_of, steps=3, max_len=16):
    rcfg, params, tcfg, model = models(arch)
    B = 3
    prompt = tokens(rcfg, B=B, S=5, seed=11)
    rc, _ = R_lm.init_lm_cache(rcfg, B, max_len, jnp.float32)
    _, rc = R_lm.lm_prefill(rcfg, params, prompt, rc)
    tc = T_lm.init_lm_cache(tcfg, B, max_len, torch.float32, device="cpu")
    T_lm.lm_prefill(tcfg, model, torch.from_numpy(prompt), tc)
    rng = np.random.default_rng(12)
    for i in range(steps):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        pos = pos_of(i)
        ref, rc = R_decode(rcfg, params, tok, rc, jnp.asarray(pos))
        out, tc = T_lm.lm_decode_step(tcfg, model, torch.from_numpy(tok), tc,
                                      torch.from_numpy(np.asarray(pos)))
        assert_close(ref, out, what=f"step {i}")
        for k in ("k", "v"):
            assert_close(rc["attn"][k], tc["attn"][k], what=f"{k} step {i}")
    return tc


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-3b"])
def test_lm_decode_step_scalar_pos(arch):
    _decode_both(arch, lambda i: np.int32(5 + i))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-2b"])
def test_lm_decode_step_per_slot_pos(arch):
    _decode_both(arch, lambda i: np.array([5 + i, 9 + 2 * i, 2], np.int32))


@pytest.mark.parametrize("pos", ["scalar", "per_slot"])
@pytest.mark.parametrize("arch", MOE)
def test_lm_decode_step_moe(arch, pos):
    """Four decode steps after a prefill; deepseek's cache is split as the
    reference splits it (layer 0 the dense block's, 1-2 the MoE blocks')."""
    if pos == "scalar":
        _decode_both(arch, lambda i: np.int32(5 + i), steps=4)
    else:
        _decode_both(arch, lambda i: np.array([5 + i, 9 + 2 * i, 2],
                                              np.int32), steps=4)


def test_lm_decode_step_at_max_len():
    """pos = max_len: the per-slot write is dropped (the other slots still
    write); the scalar write is clamped into the last position."""
    L = 16
    tc = _decode_both("llama3.2-1b",
                      lambda i: np.array([L, 6 + i, L + 3], np.int32))
    assert not tc["attn"]["k"][:, 0, 6:].any()  # nothing past the prompt
    assert tc["attn"]["k"][:, 1, 6:9].abs().sum() > 0
    tc = _decode_both("llama3.2-1b", lambda i: np.int32(L + i), steps=2)
    assert tc["attn"]["k"][:, :, L - 1].abs().sum() > 0


def test_bf16_model_over_f32_cache_fails_in_both():
    """A bfloat16 model decoding against a float32 cache: the reference's
    layer scan rejects the promoted carry, and the port raises too."""
    rcfg, params, tcfg, model = models("qwen2-0.5b", "bfloat16")
    tok = tokens(rcfg, B=2, S=1)
    rc, _ = R_lm.init_lm_cache(rcfg, 2, 8, jnp.float32)
    with pytest.raises(TypeError, match="carry"):
        R_lm.lm_decode_step(rcfg, params, tok, rc, jnp.int32(0))
    tc = T_lm.init_lm_cache(tcfg, 2, 8, torch.float32, device="cpu")
    with pytest.raises(TypeError, match="carry"):
        T_lm.lm_decode_step(tcfg, model, torch.from_numpy(tok), tc, 0)
    # over a bfloat16 cache both decode
    rc, _ = R_lm.init_lm_cache(rcfg, 2, 8, jnp.bfloat16)
    ref, _ = R_lm.lm_decode_step(rcfg, params, tok, rc, jnp.int32(0))
    tc = T_lm.init_lm_cache(tcfg, 2, 8, torch.bfloat16, device="cpu")
    out, _ = T_lm.lm_decode_step(tcfg, model, torch.from_numpy(tok), tc, 0)
    assert_close(ref, out, "bfloat16")


def test_decode_attention_layer_with_init_cache():
    rcfg = RC.get_config("qwen2.5-14b", smoke=True)
    tcfg = TC.get_config("qwen2.5-14b", smoke=True)
    rng = np.random.default_rng(13)
    ap, _ = R_attn.init_attention(rcfg, jax.random.key(9))
    ap = dict(ap, bq=jnp.asarray(rng.normal(0, 0.1, ap["bq"].shape),
                                 jnp.float32))
    a = T_attn.Attention(tcfg, device="cpu")
    with torch.no_grad():
        for k, v in ap.items():
            getattr(a, k).copy_(torch.from_numpy(np.array(v)))
    rc = R_attn.init_cache(rcfg, 2, 6, jnp.float32)
    tc = T_attn.init_cache(tcfg, 2, 6, torch.float32, device="cpu")
    for pos in range(4):
        x = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)
        ref, rc = R_attn.decode_attention(rcfg, ap, jnp.asarray(x), rc,
                                          jnp.int32(pos))
        with torch.no_grad():
            out, tc = a.decode(torch.from_numpy(x), tc, pos)
        assert_close(ref, out)
        assert_close(rc["k"], tc["k"])
