"""Parity of the port's enc-dec backbone (``repro_torch.models.encdec``)
with the JAX reference's ``repro/models/encdec.py`` on the CPU: whisper's
SMOKE config, the reference's seeded weights carried across by
``params_from_reference``, and the same seeded numpy frames and tokens.

Tolerances (max abs error over max |reference|), as in
``test_torch_models.py``: float32 2e-5, bfloat16 5e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import encdec as R_ed
from repro.models import registry as R_reg

import repro_torch.configs as TC
from repro_torch.models import encdec as T_ed
from repro_torch.models.carry import params_from_reference

ARCH = "whisper-medium"
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
_MODELS: dict = {}
R_step = jax.jit(R_ed.encdec_decode_step, static_argnums=0)


def models(dtype="float32"):
    if dtype not in _MODELS:
        rcfg = RC.get_config(ARCH, smoke=True).with_(dtype=dtype)
        tcfg = TC.get_config(ARCH, smoke=True).with_(dtype=dtype)
        params, _ = R_reg.init_model(rcfg, jax.random.key(7))
        _MODELS[dtype] = (rcfg, params, tcfg, params_from_reference(
            tcfg, jax.tree.map(np.asarray, params), device="cpu"))
    return _MODELS[dtype]


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


def frames(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).normal(
        0, 0.02, (B, S, cfg.d_model)).astype(np.float32)


def tokens(cfg, B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(16, 512), (24, 8)])
def test_encode(S, chunk, dtype):
    """Bidirectional, sinusoidal positions, no RoPE; at S = 24 in chunks
    of 8 the online softmax runs 3 x 3 chunks.  The float32 frames meet a
    bfloat16 model's positions in float32, as in the reference."""
    rcfg, params, tcfg, model = models(dtype)
    x = frames(rcfg, S=S)
    ref = R_ed.encode(rcfg, params, jnp.asarray(x), q_chunk=chunk,
                      kv_chunk=chunk, remat=False)
    port = T_ed.encode(tcfg, model, torch.from_numpy(x), q_chunk=chunk,
                       kv_chunk=chunk)
    assert str(port.dtype).split(".")[1] == str(ref.dtype)
    assert_close(ref, port, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [12, 80])
def test_decode_train(S, dtype):
    """Teacher-forced logits over the tied head; S = 80 is past
    ``max_target_len`` (64), so ``dec_pos`` is tiled.  The frames come in
    the model's dtype: float32 frames make a float32 encoder output, whose
    cross attention promotes a bfloat16 decoder's residual, and the
    reference's layer scan rejects the carry (so does the port)."""
    rcfg, params, tcfg, model = models(dtype)
    x, tok = frames(rcfg), tokens(rcfg, S=S)
    rx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    enc = R_ed.encode(rcfg, params, rx, remat=False)
    ref = R_ed.decode_train(rcfg, params, jnp.asarray(tok), enc, remat=False)
    enc_t = T_ed.encode(tcfg, model, tx)
    port = T_ed.decode_train(tcfg, model, torch.from_numpy(tok), enc_t)
    assert port.shape == (2, S, rcfg.vocab)
    assert str(port.dtype).split(".")[1] == str(ref.dtype)
    assert_close(ref, port, dtype)
    if dtype == "bfloat16":
        with pytest.raises(TypeError, match="carry"):
            R_ed.decode_train(rcfg, params, jnp.asarray(tok),
                              enc.astype(jnp.float32), remat=False)
        with pytest.raises(TypeError, match="carry"):
            T_ed.decode_train(tcfg, model, torch.from_numpy(tok),
                              enc_t.float())


@pytest.mark.parametrize("max_cross", [16, 20])
def test_prefill_and_decode_steps(max_cross):
    """``encdec_prefill`` (cross K/V from ``wk``/``wv``; the returned cross
    cache holds the encoder's 16 frames even where the cache was made for
    20), then 5 decode steps from one shared scalar position: logits and
    both caches after each."""
    rcfg, params, tcfg, model = models()
    B, x = 3, frames(rcfg, B=3, seed=2)
    rc, _ = R_ed.init_encdec_cache(rcfg, B, 8, max_cross, jnp.float32)
    rc, renc = R_ed.encdec_prefill(rcfg, params, jnp.asarray(x), rc,
                                   remat=False)
    tc = T_ed.init_encdec_cache(tcfg, B, 8, max_cross, torch.float32,
                                device="cpu")
    tc, tenc = T_ed.encdec_prefill(tcfg, model, torch.from_numpy(x), tc)
    assert_close(renc, tenc, what="enc_out")
    for k in ("k", "v"):
        assert tc["cross"][k].shape == (rcfg.n_dec_layers, B, 16,
                                        rcfg.n_kv_heads, rcfg.hd())
        assert_close(rc["cross"][k], tc["cross"][k], what=("cross", k))
    rng = np.random.default_rng(3)
    for pos in range(5):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        ref, rc = R_step(rcfg, params, jnp.asarray(tok), rc, jnp.int32(pos))
        out, tc = T_ed.encdec_decode_step(tcfg, model, torch.from_numpy(tok),
                                          tc, pos)
        assert_close(ref, out, what=("logits", pos))
        for k in ("k", "v"):
            assert_close(rc["self"][k], tc["self"][k], what=("self", k, pos))


def test_decode_step_wraps_learned_positions():
    """``pos`` past ``max_target_len`` reads ``dec_pos[pos % 64]``; the
    self cache (8 long) clamps the write to its last row, as the
    reference's ``dynamic_update_slice`` does."""
    rcfg, params, tcfg, model = models()
    x, tok = frames(rcfg, seed=4), tokens(rcfg, S=1, seed=5)
    rc, _ = R_ed.init_encdec_cache(rcfg, 2, 8, 16, jnp.float32)
    rc, _ = R_ed.encdec_prefill(rcfg, params, jnp.asarray(x), rc, remat=False)
    tc = T_ed.init_encdec_cache(tcfg, 2, 8, 16, torch.float32, device="cpu")
    tc, _ = T_ed.encdec_prefill(tcfg, model, torch.from_numpy(x), tc)
    for pos in (70, 130):
        ref, rc = R_step(rcfg, params, jnp.asarray(tok), rc, jnp.int32(pos))
        out, tc = T_ed.encdec_decode_step(tcfg, model, torch.from_numpy(tok),
                                          tc, pos)
        assert_close(ref, out, what=pos)
        assert_close(rc["self"]["k"], tc["self"]["k"], what=pos)
    assert tc["self"]["k"][:, :, -1].abs().sum() > 0


def test_bf16_decode_over_f32_cache_fails_in_both():
    """A bfloat16 decoder's attention over a float32 cache promotes the
    residual: the reference's layer scan rejects the carry, and the port
    raises too; over bfloat16 caches both decode."""
    rcfg, params, tcfg, model = models("bfloat16")
    x, tok = frames(rcfg, seed=6), tokens(rcfg, S=1, seed=7)
    for dt in ("float32", "bfloat16"):
        rc, _ = R_ed.init_encdec_cache(rcfg, 2, 8, 16, getattr(jnp, dt))
        rc, _ = R_ed.encdec_prefill(rcfg, params, jnp.asarray(x), rc,
                                    remat=False)
        tc = T_ed.init_encdec_cache(tcfg, 2, 8, 16, getattr(torch, dt),
                                    device="cpu")
        tc, _ = T_ed.encdec_prefill(tcfg, model, torch.from_numpy(x), tc)
        if dt == "float32":
            with pytest.raises(TypeError, match="carry"):
                R_ed.encdec_decode_step(rcfg, params, jnp.asarray(tok), rc,
                                        jnp.int32(0))
            with pytest.raises(TypeError, match="carry"):
                T_ed.encdec_decode_step(tcfg, model, torch.from_numpy(tok),
                                        tc, 0)
            continue
        ref, _ = R_ed.encdec_decode_step(rcfg, params, jnp.asarray(tok), rc,
                                         jnp.int32(0))
        out, _ = T_ed.encdec_decode_step(tcfg, model, torch.from_numpy(tok),
                                         tc, 0)
        assert out.dtype == torch.bfloat16
        assert_close(ref, out, "bfloat16")
