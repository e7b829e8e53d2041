"""The port's train step and training launcher (``repro_torch.launch``)
against the reference, on the CPU.

``build_train_step`` in both packages starts from one state (the
reference's, carried by ``state_from_reference``) and takes 3 steps on the
same batches; every leaf of params, m and v must stay within 1e-4 x max
|ref leaf|, and the loss, ``lr`` and ``grad_norm`` within 1e-4 relative.
Why 1e-4: the losses and gradients agree to about 1e-6 x max
(``tests/test_torch_train_losses.py``), and AdamW divides each update by
sqrt(v), which magnifies a gradient's relative error where the gradient
is small; three steps stay well inside 1e-4.
"""
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import pipeline as R_data
from repro.launch import train as R_train
from repro.launch.mesh import make_local_mesh as R_mesh
from repro.launch.steps import build_train_step as R_build
from repro.launch.steps import init_train_state as R_init
from repro.models import registry as R_reg
from repro.models.config import ShapeConfig as R_Shape
from repro.optim.adamw import OptConfig as R_Opt

import repro_torch.configs as TC
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as T_train
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models.carry import state_from_reference, state_to_numpy
from repro_torch.models.config import ShapeConfig
from repro_torch.optim.adamw import OptConfig

TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def batches(rcfg, shape, synthetic, n=3):
    if synthetic:
        data = R_data.SyntheticLM(rcfg.vocab, shape.seq_len,
                                  shape.global_batch, seed=0)
        return [data.next_batch() for _ in range(n)]
    return [jax.tree.map(np.asarray, R_reg.make_batch(rcfg, shape, seed=i))
            for i in range(n)]


def assert_state_close(got, want):
    for field in ("params", "m", "v"):
        for path, w in jax.tree_util.tree_flatten_with_path(want[field])[0]:
            node = got[field]
            for k in path:
                node = node[k.key]
            err = float(np.abs(node - w).max())
            assert err <= TOL * max(float(np.abs(w).max()), 1e-30), (
                field, path, err)


@pytest.mark.parametrize("arch,n_acc,synthetic", [
    ("llama3.2-1b", 1, True),
    ("llama3.2-1b", 2, True),
    ("deepseek-moe-16b", 2, True),
    ("whisper-medium", 2, False),
])
def test_train_steps_match_reference(arch, n_acc, synthetic):
    """3 steps, microbatches accumulated in order at ``n_acc`` 2; the
    SyntheticLM batches carry the ``masked`` loss mask (whisper takes
    ``make_batch``'s frames, unmasked, as the reference's smoke test)."""
    rcfg, tcfg = RC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    rshape = R_Shape("s", "train", seq_len=32, global_batch=4)
    tshape = ShapeConfig("s", "train", seq_len=32, global_batch=4)
    rb = R_build(rcfg, rshape, R_mesh(1, 1), R_Opt(**OPT), n_acc=n_acc,
                 masked=synthetic)
    tb = build_train_step(tcfg, tshape, make_local_mesh(1, 1, device="cpu"),
                          OptConfig(**OPT), n_acc=n_acc, masked=synthetic)
    assert tb.meta["n_acc"] == rb.meta["n_acc"] == n_acc
    rstate = R_init(rcfg, rb, seed=1)
    tstate = state_from_reference(tcfg, jax.tree.map(np.asarray, rstate),
                                  device="cpu")
    for batch in batches(rcfg, rshape, synthetic):
        rstate, rm = rb.fn(rstate, batch)
        tstate, tm = tb.fn(tstate, batch)
        for k in ("loss", "lr", "grad_norm"):
            assert abs(float(tm[k]) - float(rm[k])) <= TOL * abs(float(rm[k]))
    assert int(tstate.step) == 3
    assert_state_close(state_to_numpy(tstate), {
        f: jax.tree.map(np.asarray, getattr(rstate, f))
        for f in ("params", "m", "v")})


def test_moe_embed_spread_is_adamw_on_near_zero_gradients():
    """deepseek-moe-16b's ``embed`` leaf lies 2.1e-4 x max from the
    reference's after one step on one device (5.5e-4 after two, the spread
    ``test_torch_sharded_step.py`` widens by), past 1e-4 x max, though the
    step's gradient agrees: its m and v (0.1 g and 0.05 g**2 after one
    step) lie within 1e-5 x max on every leaf.  The first update is
    lr * g / (|g| + eps), whose slope lr * eps / (|g| + eps)**2 turns a
    float32 rounding of a near-cancelling gradient sum (|g| near eps =
    1e-8; three quarters of the tied table's gradient lies below 1e-7) into
    a visible step.  So every entry off by more than 1e-4 x max has |g| at
    most 1e-6: the summation order, not a fault (the sharded test's state
    and batch: seed 0, n_acc 2, 4 x 32 tokens)."""
    arch = "deepseek-moe-16b"
    rcfg, tcfg = RC.get_config(arch, smoke=True), TC.get_config(arch, smoke=True)
    rshape = R_Shape("s", "train", seq_len=32, global_batch=4)
    tshape = ShapeConfig("s", "train", seq_len=32, global_batch=4)
    rb = R_build(rcfg, rshape, R_mesh(1, 1), R_Opt(**OPT), n_acc=2,
                 masked=True)
    tb = build_train_step(tcfg, tshape, make_local_mesh(1, 1, device="cpu"),
                          OptConfig(**OPT), n_acc=2, masked=True)
    rstate = R_init(rcfg, rb)
    tstate = state_from_reference(tcfg, jax.tree.map(np.asarray, rstate),
                                  device="cpu")
    batch = batches(rcfg, rshape, True, n=1)[0]
    rstate, _ = rb.fn(rstate, batch)
    tstate, _ = tb.fn(tstate, batch)
    got = state_to_numpy(tstate)
    want = {f: jax.tree.map(np.asarray, getattr(rstate, f))
            for f in ("params", "m", "v")}
    spread = {}
    for path, p_ref in jax.tree_util.tree_flatten_with_path(want["params"])[0]:
        leaf = {}
        for f in ("params", "m", "v"):
            node, ref = got[f], want[f]
            for k in path:
                node, ref = node[k.key], ref[k.key]
            leaf[f] = (np.asarray(node, np.float64), np.asarray(ref, np.float64))
        for f in ("m", "v"):
            a, b = leaf[f]
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), (f, path)
        a, b = leaf["params"]
        off = np.abs(a - b) > 1e-4 * np.abs(b).max()
        g = np.abs(leaf["m"][1]) / (1 - 0.9)
        assert (g[off] <= 1e-6).all(), (path, g[off].max())
        spread[jax.tree_util.keystr(path)] = np.abs(a - b).max() / np.abs(b).max()
    assert spread["['embed']"] > 1e-4, spread["['embed']"]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-7b"])
def test_bfloat16_step_casts_every_leaf(arch):
    """Under a bfloat16 config the step's compute copy is bfloat16 in every
    leaf, the MoE router and the SSM's ``A_log`` and ``D`` included, as the
    reference casts them; the masters stay float32 and the step trains."""
    cfg = TC.get_config(arch, smoke=True).with_(dtype="bfloat16")
    shape = ShapeConfig("s", "train", seq_len=32, global_batch=2)
    built = build_train_step(cfg, shape, make_local_mesh(1, 1, device="cpu"),
                             OptConfig(**OPT), masked=True)
    model = built.meta["compute_model"]
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    state = init_train_state(cfg, built)
    assert {t.dtype for t in state.params.values()} == {torch.float32}
    data = SyntheticLM(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    losses = []
    for _ in range(2):
        state, m = built.fn(state, data.next_batch())
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()


def test_step_checks_its_inputs_and_abstract_args():
    """A batch without the step's inputs raises ``ValueError``, as the
    reference's jitted step rejects the pytree; ``abstract_args`` holds
    meta tensors of the state's and the batch's shapes."""
    cfg = TC.get_config("internvl2-2b", smoke=True)
    shape = ShapeConfig("s", "train", seq_len=32, global_batch=2)
    built = build_train_step(cfg, shape, make_local_mesh(1, 1, device="cpu"),
                             masked=True)
    state = init_train_state(cfg, built)
    batch = SyntheticLM(cfg.vocab, 32, 2, seed=0).next_batch()
    with pytest.raises(ValueError, match="patch_embeds"):
        built.fn(state, batch)
    abstract_state, abstract_batch = built.abstract_args
    assert set(abstract_batch) == {"tokens", "labels", "loss_mask",
                                   "patch_embeds"}
    assert all(t.device.type == "meta" for t in abstract_batch.values())
    assert {k: tuple(t.shape) for k, t in abstract_state.params.items()} == \
        {k: tuple(t.shape) for k, t in state.params.items()}


def test_meshes():
    """A (1, 1) mesh on an explicit device; more devices than the machine
    has fail as the reference's do."""
    mesh = make_local_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device == torch.device("cpu")
    with pytest.raises(AssertionError, match="need 2 devices"):
        make_local_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="Number of devices"):
        make_production_mesh(device="cpu")


def run_reference_launcher(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    R_train.main()
    return capsys.readouterr().out.splitlines()


def test_launcher_prints_the_reference_placement_and_trains(
        monkeypatch, capsys, tmp_path):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--steps"]
    want = run_reference_launcher(monkeypatch, capsys, argv + [
        "2", "--ckpt-dir", str(tmp_path / "r")])  # its placement line
    tr = T_train.main(argv + ["20", "--ckpt-dir", str(tmp_path / "p"),
                              "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] and got[0].startswith("[placement] ")
    assert got[1].startswith("llama3.2-1b: 20 steps, loss ")
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        ["step_00000010", "step_00000020"]


@pytest.mark.parametrize("arch,missing", [("internvl2-2b", "patch_embeds"),
                                          ("whisper-medium", "frames")])
def test_launcher_fails_for_vlm_and_encdec_as_the_reference(
        monkeypatch, capsys, tmp_path, arch, missing):
    """``SyntheticLM`` yields no ``patch_embeds`` or ``frames``: every step
    raises ``ValueError`` in both launchers, each trainer restarts 3 times
    and then raises (a fault of the reference the port mirrors)."""
    argv = ["--arch", arch, "--smoke", "--steps", "2"]
    with pytest.raises(ValueError):
        run_reference_launcher(monkeypatch, capsys,
                               argv + ["--ckpt-dir", str(tmp_path / "r")])
    with pytest.raises(ValueError, match=missing):
        T_train.main(argv + ["--ckpt-dir", str(tmp_path / "p"),
                             "--device", "cpu"])


def test_launcher_without_smoke_needs_the_production_mesh(tmp_path):
    with pytest.raises(ValueError, match="Number of devices"):
        T_train.main(["--arch", "llama3.2-1b", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
