"""Parity of the port's serving engine (``repro_torch.serving``) and its
launcher (``repro_torch.launch.serve``) with the JAX reference on the CPU.

Greedy decoding is compared token for token (float32, weights carried by
``params_from_reference``); the KV caches the engines end with within the
float32 tolerance of ``test_torch_models.py``.  A draw from
``jax.random.categorical`` cannot be matched by a torch generator, so
sampled tokens are checked for support (inside the top-k set) and for
seeded reproducibility within the port."""
import ast
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch import serve as R_serve
from repro.models.config import ModelConfig as R_Config
from repro.models.registry import init_model as R_init
from repro.serving import Engine as R_Engine
from repro.serving import Request as R_Request
from repro.serving import cache_insert as R_cache_insert
from repro.serving import sample_logits as R_sample_logits

import repro_torch.configs as TC
from repro_torch.launch import serve as T_serve
from repro_torch.models import moe as T_moe
from repro_torch.models import transformer as T_lm
from repro_torch.models.carry import params_from_reference
from repro_torch.models.config import ModelConfig as T_Config
from repro_torch.serving import Engine, Request, cache_insert, mask_top_k, \
    sample_logits

# the reference's tests/test_serving.py configuration
FIELDS = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=128, dtype="float32")
RCFG, TCFG = R_Config(**FIELDS), T_Config(**FIELDS)


def _pair(seed):
    params, _ = R_init(RCFG, jax.random.key(seed))
    return params, params_from_reference(
        TCFG, jax.tree.map(np.asarray, params), device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, size=L).astype(np.int32)
            for L in (5, 9, 7, 4, 6)]


def _straightline_greedy(model, prompt, n_new):
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            lg, _ = T_lm.lm_forward(TCFG, model, torch.tensor([toks]),
                                    logits_mode="last")
            toks.append(int(torch.argmax(lg[0, -1])))
    return toks[len(prompt):]


def test_engine_greedy_tokens_equal_the_reference_engine():
    """The reference's scenario: 5 prompts through 2 slots, 6 new tokens
    each.  Same tokens, same finishing order, same ticks; the engines'
    caches agree (stale per-slot writes of idle slots included)."""
    params, model = _pair(0)
    ref = R_Engine(RCFG, params, n_slots=2, max_len=64, temperature=0.0)
    eng = Engine(TCFG, model, n_slots=2, max_len=64, temperature=0.0,
                 device="cpu")
    for i, p in enumerate(_prompts()):
        ref.submit(R_Request(rid=i, prompt=p, max_new=6))
        eng.submit(Request(rid=i, prompt=p, max_new=6))
    rdone, rticks = ref.run()
    done, ticks = eng.run()
    assert ticks == rticks
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in rdone]
    np.testing.assert_array_equal(eng.pos, ref.pos)
    for k in ("k", "v"):
        a = np.asarray(ref.cache["attn"][k])
        b = eng.cache["attn"][k].numpy()
        assert np.abs(a - b).max() <= 2e-5 * np.abs(a).max(), k
    # and the port's engine equals its own straight-line greedy
    for req in done:
        assert req.out == _straightline_greedy(model, req.prompt, 6), req.rid


def _moe_pair(arch, **moe):
    """The reference's SMOKE MoE params (seed 0) and the port's model
    holding them, with MoE fields of both configs set."""
    cfgs = []
    for pkg in (RC, TC):
        cfg = pkg.get_config(arch, smoke=True)
        cfgs.append(cfg.with_(moe=dataclasses.replace(cfg.moe, **moe)))
    rcfg, tcfg = cfgs
    params, _ = R_init(rcfg, jax.random.key(0))
    return rcfg, params, tcfg, params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def _moe_engines(arch, slots, **moe):
    """Both engines, greedy, over the same 4 requests (more than the
    slots: slots are refilled), and the port's (T, dropped pairs) per MoE
    call."""
    rcfg, params, tcfg, model = _moe_pair(arch, **moe)
    ref = R_Engine(rcfg, params, n_slots=slots, max_len=48, temperature=0.0)
    eng = Engine(tcfg, model, n_slots=slots, max_len=48, temperature=0.0,
                 device="cpu")
    rng = np.random.default_rng(3)
    for i, L in enumerate((6, 11, 4, 9)):
        p = rng.integers(0, tcfg.vocab, L).astype(np.int32)
        ref.submit(R_Request(rid=i, prompt=p, max_new=7))
        eng.submit(Request(rid=i, prompt=p, max_new=7))
    calls = []

    def hook(mod, args):
        x = args[0]
        r = T_moe.route(tcfg, mod.router, x.reshape(-1, x.shape[-1]))
        calls.append((x.shape[0] * x.shape[1], int((~r.keep).sum())))

    for blk in model.blocks:
        blk.moe.register_forward_pre_hook(hook)
    rdone, rticks = ref.run()
    done, ticks = eng.run()
    assert ticks == rticks
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in rdone]
    np.testing.assert_array_equal(eng.pos, ref.pos)
    for k in ("k", "v"):
        a = np.asarray(ref.cache["attn"][k])
        b = eng.cache["attn"][k].numpy()
        assert np.abs(a - b).max() <= 2e-5 * np.abs(a).max(), k
    return calls


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"])
def test_moe_engine_greedy_tokens_equal_the_reference_engine(arch):
    """2 slots, 4 requests: the same tokens, finishing order, ticks and
    caches (deepseek's split into its dense-first and MoE layers)."""
    calls = _moe_engines(arch, 2)
    assert any(T == 2 for T, _ in calls)  # decode ticks routed both slots


def test_moe_engine_with_decode_drops_equals_the_reference_engine():
    """Capacity 0.5 drops pairs in decode ticks too.  A tick routes one
    token per slot, each to k distinct experts, and C >= k: with 2 slots
    no expert can overflow, so this run uses 3 (phi3.5: E 4, top-2, C 2).
    The same tokens as the reference's engine, whose drops couple the
    slots the same way."""
    calls = _moe_engines("phi3.5-moe-42b-a6.6b", 3, capacity_factor=0.5)
    assert sum(d for T, d in calls if T == 3) > 0, calls
    assert sum(d for T, d in calls if T != 3) > 0, calls  # prefills


def test_engine_more_requests_than_slots_samples_in_support():
    _, model = _pair(1)

    def run(seed):
        eng = Engine(TCFG, model, n_slots=2, max_len=32, temperature=0.7,
                     top_k=8, seed=seed, device="cpu")
        for i in range(5):
            eng.submit(Request(rid=i, prompt=np.arange(3 + i) % 128,
                               max_new=4))
        return eng.run()

    done, _ = run(3)
    assert len(done) == 5
    assert all(len(r.out) == 4 for r in done)
    assert all(0 <= t < 128 for r in done for t in r.out)
    again, _ = run(3)
    assert [r.out for r in done] == [r.out for r in again]


def test_sampling_support_and_seeding():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(0, 2, (6, 300)).astype(np.float32))
    draws = []
    for seed in (11, 11, 12):
        g = torch.Generator().manual_seed(seed)
        draws.append(torch.stack([sample_logits(g, logits, temperature=0.7,
                                                top_k=5) for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert draws[0].dtype == torch.int32
    for row in range(6):
        allowed = set(torch.topk(logits[row], 5).indices.tolist())
        assert set(draws[0][:, row].tolist()) <= allowed
    # greedy: argmax, the first index on ties, in both packages
    tied = np.zeros((2, 9), np.float32)
    tied[0, [2, 5]] = 1.0
    tied[1, [7, 3]] = 2.0
    ref = np.asarray(R_sample_logits(jax.random.key(0), jnp.asarray(tied),
                                     temperature=0.0))
    port = sample_logits(None, torch.from_numpy(tied), temperature=0.0)
    np.testing.assert_array_equal(ref, port.numpy())
    assert port.tolist() == [2, 3]


def test_top_k_mask_equals_the_references():
    """The masked logits of ``serving/engine.py:30-32``, with ties at the
    k-th value kept."""
    rng = np.random.default_rng(5)
    logits = rng.integers(-4, 5, (5, 40)).astype(np.float32) / 2  # ties
    for k in (1, 3, 8):
        v, _ = jax.lax.top_k(jnp.asarray(logits), k)
        ref = jnp.where(jnp.asarray(logits) < v[:, -1:], -1e30,
                        jnp.asarray(logits))
        port = mask_top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(np.asarray(ref), port.numpy())


def test_cache_insert_equals_the_references():
    rng = np.random.default_rng(6)
    pool = {"attn": {k: rng.normal(size=(2, 3, 5, 1, 4)).astype(np.float32)
                     for k in ("k", "v")}}
    one = {"attn": {k: rng.normal(size=(2, 1, 5, 1, 4)).astype(np.float32)
                    for k in ("k", "v")}}
    ref = R_cache_insert(jax.tree.map(jnp.asarray, pool),
                         jax.tree.map(jnp.asarray, one), 1)
    port = cache_insert(
        {"attn": {k: torch.from_numpy(v.copy()) for k, v in
                  pool["attn"].items()}},
        {"attn": {k: torch.from_numpy(v) for k, v in one["attn"].items()}}, 1)
    for k in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(ref["attn"][k]),
                                      port["attn"][k].numpy())


def test_bfloat16_engine_raises_where_the_reference_fails():
    """The reference engine's float32 cache cannot carry a bfloat16
    model's activations: its first decode step fails in the layer scan.
    The port refuses the config up front."""
    rcfg = RCFG.with_(dtype="bfloat16")
    params, _ = R_init(rcfg, jax.random.key(0))
    ref = R_Engine(rcfg, params, n_slots=2, max_len=32)
    ref.submit(R_Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=4))
    with pytest.raises(TypeError, match="carry"):
        ref.run()
    tcfg = TCFG.with_(dtype="bfloat16")
    model = params_from_reference(tcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    with pytest.raises(ValueError, match="float32"):
        Engine(tcfg, model, n_slots=2, max_len=32, device="cpu")


def test_engine_refuses_enc_dec():
    """The reference's engine asserts a decoder-only family; the port's
    raises for whisper too."""
    rcfg = RC.get_config("whisper-medium", smoke=True)
    with pytest.raises(AssertionError):
        R_Engine(rcfg, None)
    with pytest.raises(ValueError, match="encdec"):
        Engine(TC.get_config("whisper-medium", smoke=True), None,
               device="cpu")


def _carried(arch, dtype="float32"):
    """The reference's SMOKE params (seed 0) and the port's model holding
    them."""
    rcfg = RC.get_config(arch, smoke=True).with_(dtype=dtype)
    tcfg = TC.get_config(arch, smoke=True).with_(dtype=dtype)
    params, _ = R_init(rcfg, jax.random.key(0))
    return rcfg, params, tcfg, params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


def _requests(vocab, lens=(6, 11, 4, 9), new=7):
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, vocab, L).astype(np.int32), new)
            for i, L in enumerate(lens)]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_engine_greedy_tokens_equal_the_reference_engine(arch):
    """2 slots, 4 requests (slots refilled): the same tokens, finishing
    order and ticks; the SSM states (L, B, ...) inserted per slot and, for
    zamba2, the shared block's per-call-site KV caches end equal."""
    rcfg, params, tcfg, model = _carried(arch)
    ref = R_Engine(rcfg, params, n_slots=2, max_len=48, temperature=0.0)
    eng = Engine(tcfg, model, n_slots=2, max_len=48, temperature=0.0,
                 device="cpu")
    for rid, p, new in _requests(tcfg.vocab):
        ref.submit(R_Request(rid=rid, prompt=p, max_new=new))
        eng.submit(Request(rid=rid, prompt=p, max_new=new))
    rdone, rticks = ref.run()
    done, ticks = eng.run()
    assert ticks == rticks
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in rdone]
    np.testing.assert_array_equal(eng.pos, ref.pos)
    assert sorted(eng.cache) == sorted(ref.cache)
    for group, leaves in eng.cache.items():
        for k, v in leaves.items():
            a = np.asarray(ref.cache[group][k])
            assert np.abs(a - v.numpy()).max() <= 2e-5 * np.abs(a).max(), \
                (group, k)


def test_bfloat16_ssm_engine_serves_in_both():
    """A bfloat16 falcon-mamba decodes over the engines' float32 states
    without promoting its residual, so the reference's engine serves it,
    and so does the port's: the same greedy tokens and ticks as the
    reference's engine (the smallest top-2 gap of these decodes is 0.094,
    six bfloat16 steps at the logits' magnitude, so no near tie), its
    float32 states within the bfloat16 tolerance of the reference's, and
    its tokens equal to its own lm_prefill + lm_decode_step at batch 1
    (one slot, as each slot's state is its own)."""
    rcfg, params, tcfg, model = _carried("falcon-mamba-7b", "bfloat16")
    reqs = _requests(tcfg.vocab, lens=(6, 9), new=5)
    ref = R_Engine(rcfg, params, n_slots=2, max_len=32)
    for rid, p, new in reqs:
        ref.submit(R_Request(rid=rid, prompt=p, max_new=new))
    rdone, rticks = ref.run()
    assert [len(r.out) for r in rdone] == [5, 5]
    eng = Engine(tcfg, model, n_slots=2, max_len=32, device="cpu")
    for rid, p, new in reqs:
        eng.submit(Request(rid=rid, prompt=p, max_new=new))
    done, ticks = eng.run()
    assert ticks == rticks
    assert [(r.rid, r.out) for r in done] == [(r.rid, r.out) for r in rdone]
    for group, leaves in eng.cache.items():
        for k, v in leaves.items():
            assert v.dtype == torch.float32, (group, k)
            a = np.asarray(ref.cache[group][k], np.float32)
            assert np.abs(a - v.numpy()).max() <= 5e-2 * np.abs(a).max(), \
                (group, k)
    for req in done:
        cache = T_lm.init_lm_cache(tcfg, 1, 32, torch.float32, device="cpu")
        lg, cache = T_lm.lm_prefill(tcfg, model,
                                    torch.from_numpy(req.prompt[None]), cache)
        want = [int(torch.argmax(lg[0, -1]))]
        for i in range(4):
            lg, cache = T_lm.lm_decode_step(
                tcfg, model, torch.tensor([[want[-1]]]), cache,
                len(req.prompt) + i)
            want.append(int(torch.argmax(lg[0, -1])))
        assert req.out == want, req.rid


def test_bfloat16_hybrid_engine_raises_where_the_reference_fails():
    """zamba2's shared block attends to the float32 cache: the reference's
    first decode tick fails in its group scan, and the port refuses the
    config up front."""
    rcfg, params, tcfg, model = _carried("zamba2-7b", "bfloat16")
    ref = R_Engine(rcfg, params, n_slots=2, max_len=32)
    ref.submit(R_Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=4))
    with pytest.raises(TypeError, match="carry"):
        ref.run()
    with pytest.raises(ValueError, match="float32"):
        Engine(tcfg, model, n_slots=2, max_len=32, device="cpu")


def _run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


LAUNCHER_ARCHS = ["qwen2-0.5b", "internvl2-2b", "phi3.5-moe-42b-a6.6b",
                  "deepseek-moe-16b", "falcon-mamba-7b", "zamba2-7b",
                  "whisper-medium"]


@pytest.mark.parametrize("arch,weights",
                         [(a, "own") for a in LAUNCHER_ARCHS]
                         + [("whisper-medium", "carried")])
def test_serve_launcher_matches_the_reference(arch, weights, monkeypatch):
    """Each launcher draws its own seed-0 weights ("own"): the same
    placement line, and for the engine archs the same request, token and
    tick counts (their weights and sampled tokens come from different
    generators); whisper's enc-dec branch decodes ``--max-new`` in-vocab
    greedy tokens for each stream.  With the reference's weights carried
    into the port's launcher ("carried"), whisper's greedy tokens are
    equal, every token of every stream."""
    argv = ["--arch", arch, "--requests", "3", "--max-new", "5"]
    rcfg = RC.get_config(arch, smoke=True)
    if weights == "carried":
        _, _, _, model = _carried(arch)

        def init_model(cfg, generator, *, device):
            assert cfg == TC.get_config(arch, smoke=True)
            assert device.type == "cpu"
            return model
        monkeypatch.setattr(T_serve, "init_model", init_model)
    ref = _run_main(_argv_main(R_serve.main), argv)
    port = _run_main(T_serve.main, argv + ["--device", "cpu"])
    assert port[0].startswith("[placement]")
    if rcfg.family != "encdec":
        assert ref == port
        assert port[-1].startswith(f"{arch}: served 3 requests")
        return
    head = f"{arch} (enc-dec): decoded 5 steps x 3 streams: "
    assert len(port) == len(ref) == 2 and port[0] == ref[0]
    assert port[1].startswith(head) and ref[1].startswith(head)
    streams = ast.literal_eval(port[1][len(head):])
    assert [len(s) for s in streams] == [5, 5, 5]
    assert all(0 <= tok < rcfg.vocab for s in streams for tok in s)
    if weights == "carried":
        assert ref == port


def _argv_main(main):
    """The reference's ``main`` reads ``sys.argv``."""
    def run(argv):
        saved = sys.argv
        sys.argv = ["serve"] + argv
        try:
            main()
        finally:
            sys.argv = saved
    return run
