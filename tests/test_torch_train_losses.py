"""Training losses and their gradients: the port (``repro_torch``) against
the JAX reference for every arch's SMOKE config, on the CPU.

Both packages get the reference's weights (key 7, carried by
``params_from_reference``) and the same seeded batch (``make_batch`` plus a
seeded 0/1 ``loss_mask``); the attention runs in chunks of 8 queries and
16 keys, so the online softmax and its checkpointed recompute run over
several chunk pairs.  The reference differentiates ``loss_fn(cfg)`` under
``jax.value_and_grad`` with its default ``remat=True``; the port with
``torch.autograd`` and ``remat`` on and off.

Tolerances, and why:
- float32 loss within 2e-5 x |ref| and each gradient leaf within 1e-4 x
  max |ref leaf|: the same arithmetic in the same dtype, but the two
  packages' CPU kernels sum in different orders (the first readings were
  about 3e-7 and 6e-6);
- the port's gradients with remat on equal those with remat off bitwise:
  a checkpointed block recomputes the same operations on the same values;
- bfloat16 (one dense case) within 5e-2 x max: each package rounds its
  intermediates to bfloat16 at its own points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import registry as R_reg
from repro.models.config import ShapeConfig as R_Shape

import repro_torch.configs as TC
from repro_torch.models import encdec as T_ed
from repro_torch.models import registry as T_reg
from repro_torch.models import transformer as T_lm
from repro_torch.models.carry import named_from_reference, params_from_reference

SEQ, BATCH = 32, 2
CHUNKS = dict(q_chunk=8, kv_chunk=16)
LOSS_TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 5e-2


def setup(arch, dtype="float32", seed=3):
    rcfg = RC.get_config(arch, smoke=True).with_(dtype=dtype)
    tcfg = TC.get_config(arch, smoke=True).with_(dtype=dtype)
    params, _ = R_reg.init_model(rcfg, jax.random.key(7))
    batch = R_reg.make_batch(rcfg, R_Shape("s", "train", SEQ, BATCH), seed=seed)
    mask = np.random.default_rng(seed).integers(
        0, 2, batch["labels"].shape).astype(np.float32)
    batch["loss_mask"] = jnp.asarray(mask)
    model = params_from_reference(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    tb = {k: torch.from_numpy(np.array(v.astype(jnp.float32)
                                       if v.dtype == jnp.bfloat16 else v))
          for k, v in batch.items()}
    for k in ("patch_embeds", "frames"):
        if k in tb:
            tb[k] = tb[k].to(getattr(torch, dtype))
    return rcfg, params, batch, tcfg, model, tb


def ref_value_and_grad(rcfg, params, batch):
    loss = R_reg.loss_fn(rcfg)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: loss(rcfg, p, b, remat=True, **CHUNKS)))
    l, g = f(params, batch)
    return float(l), jax.tree.map(
        lambda t: np.asarray(t.astype(jnp.float32)), g)


def port_value_and_grad(tcfg, model, tb, remat):
    l = T_reg.loss_fn(tcfg)(tcfg, model, tb, remat=remat, **CHUNKS)
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(l, [p for _, p in model.named_parameters()])
    return float(l.detach()), dict(zip(names, gs))


def assert_grads_close(tcfg, ref_grads, port_grads, tol):
    want = named_from_reference(tcfg, ref_grads, device="cpu")
    assert set(want) == set(port_grads)
    for name, w in want.items():
        g = port_grads[name].detach().to(torch.float32)
        scale = max(float(w.abs().max()), 1e-30)
        err = float((w - g).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """Every family: the dense/VLM loss (image positions dropped), the MoE
    aux loss (through checkpointed blocks), the SSM scans, the hybrid's
    shared block (its gradients summed over its call sites) and the
    enc-dec loss through ``encode`` and ``decode_train``."""
    rcfg, params, batch, tcfg, model, tb = setup(arch)
    l_ref, g_ref = ref_value_and_grad(rcfg, params, batch)
    got = {}
    for remat in (True, False):
        l, g = port_value_and_grad(tcfg, model, tb, remat)
        assert abs(l - l_ref) <= LOSS_TOL * abs(l_ref), (remat, l, l_ref)
        assert_grads_close(tcfg, g_ref, g, GRAD_TOL)
        got[remat] = (l, g)
    assert got[True][0] == got[False][0]
    for name, g in got[True][1].items():
        assert torch.equal(g, got[False][1][name]), name


def test_bfloat16_dense_loss_and_gradients():
    rcfg, params, batch, tcfg, model, tb = setup("llama3.2-1b", "bfloat16")
    l_ref, g_ref = ref_value_and_grad(rcfg, params, batch)
    l, g = port_value_and_grad(tcfg, model, tb, remat=True)
    assert abs(l - l_ref) <= BF16_TOL * abs(l_ref)
    assert all(t.dtype == torch.bfloat16 for t in g.values())
    assert_grads_close(tcfg, g_ref, g, BF16_TOL)


def test_loss_fn_dispatch_and_vlm_positions():
    """``loss_fn`` picks ``encdec_loss`` for the enc-dec family and
    ``lm_loss`` otherwise; the VLM's loss is the text positions' alone."""
    assert T_reg.loss_fn(TC.get_config("whisper-medium", smoke=True)) \
        is T_ed.encdec_loss
    assert T_reg.loss_fn(TC.get_config("qwen2-0.5b", smoke=True)) \
        is T_lm.lm_loss
    _, _, _, tcfg, model, tb = setup("internvl2-2b")
    with torch.no_grad():
        logits, aux = T_lm.lm_forward(tcfg, model, tb["tokens"],
                                      patch_embeds=tb["patch_embeds"])
        n_img = tb["patch_embeds"].shape[1]
        want = T_lm.softmax_cross_entropy(logits[:, n_img:], tb["labels"],
                                          tb["loss_mask"]) + aux
        got = T_lm.lm_loss(tcfg, model, tb)
    assert float(got) == float(want)


def test_serving_paths_keep_no_grad_and_record_nothing():
    """The serving entry points run without autograd (so ``remat`` never
    checkpoints there); ``encode`` and ``decode_train`` now record a
    graph for training."""
    _, _, _, tcfg, model, tb = setup("whisper-medium")
    cache = T_ed.init_encdec_cache(tcfg, BATCH, 16, SEQ, torch.float32,
                                   device="cpu")
    cache, enc = T_ed.encdec_prefill(tcfg, model, tb["frames"], cache)
    assert not enc.requires_grad
    assert T_ed.encode(tcfg, model, tb["frames"]).requires_grad
    _, _, _, tcfg, model, tb = setup("qwen2-0.5b")
    cache = T_lm.init_lm_cache(tcfg, BATCH, 48, torch.float32, device="cpu")
    logits, _ = T_lm.lm_prefill(tcfg, model, tb["tokens"], cache)
    assert not logits.requires_grad


@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 16), (16, 8), (12, 24)])
def test_skipping_hidden_chunk_pairs_changes_no_bit(monkeypatch, q_chunk,
                                                    kv_chunk):
    """The causal attention skips the KV chunks a query chunk's mask hides
    whole; computing every pair, as the reference does, gives the same
    output and gradients bit for bit."""
    from repro_torch.models import attention as T_attn

    rng = np.random.default_rng(0)
    shapes = [(2, 48, 4, 8), (2, 48, 2, 8), (2, 48, 2, 8)]
    leaves = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              .requires_grad_() for s in shapes]

    def run():
        out = T_attn._chunked_attention(*leaves, causal=True,
                                        q_chunk=q_chunk, kv_chunk=kv_chunk)
        return [out.detach()] + list(torch.autograd.grad(
            (out * out).sum(), leaves))

    live = run()
    hidden = sum(T_attn.live_kv_chunks(qi, q_chunk, kv_chunk, 48 // kv_chunk,
                                       True) < 48 // kv_chunk
                 for qi in range(48 // q_chunk))
    assert hidden > 0
    monkeypatch.setattr(T_attn, "live_kv_chunks",
                        lambda qi, qc, kc, nkc, causal: nkc)
    for a, b in zip(live, run()):
        assert torch.equal(a, b)
