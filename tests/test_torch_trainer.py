"""The port's data pipeline, checkpoints and fault-tolerant trainer
(``repro_torch.data``, ``ckpt``, ``runtime``) against the reference, on
the CPU: ``SyntheticLM`` batches bitwise, the checkpoint layout, and the
ports of ``tests/test_runtime.py``'s checkpoint, failure-injection,
straggler and prefetcher tests, with the trainers' event sequences
compared under the same injection."""
import json
import time

import numpy as np
import pytest
import torch

from repro.data import pipeline as R_data
from repro.launch.mesh import make_local_mesh as R_mesh
from repro.launch.steps import build_train_step as R_build
from repro.launch.steps import init_train_state as R_init
from repro.models.config import ModelConfig as R_Model
from repro.models.config import ShapeConfig as R_Shape
from repro.optim.adamw import OptConfig as R_Opt
from repro.runtime.trainer import Trainer as R_Trainer
from repro.runtime.trainer import TrainerConfig as R_TrainerConfig

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import OptConfig, TrainState
from repro_torch.runtime.trainer import Trainer, TrainerConfig

FIELDS = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=128, dtype="float32")
CFG, R_CFG = ModelConfig(**FIELDS), R_Model(**FIELDS)
SHAPE, R_SHAPE = (ShapeConfig("s", "train", seq_len=16, global_batch=4),
                  R_Shape("s", "train", seq_len=16, global_batch=4))


@pytest.mark.parametrize("vocab,seq,batch,kw", [
    (128256, 64, 4, {}),
    (64, 8, 2, {"seed": 1}),
    (1000, 300, 6, {"seed": 3, "process_index": 1, "process_count": 3,
                    "doc_len_range": (5, 40)}),
])
def test_synthetic_batches_bitwise(vocab, seq, batch, kw):
    ref = R_data.SyntheticLM(vocab, seq, batch, **kw)
    port = SyntheticLM(vocab, seq, batch, **kw)
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetcher():
    it = Prefetcher(iter(SyntheticLM(64, 8, 2, seed=1)), depth=2)
    batches = [next(it) for _ in range(3)]
    assert all(b["tokens"].shape == (2, 8) for b in batches)
    # learnable structure: next token is an affine function within documents
    b = batches[0]
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()
    ref = R_data.Prefetcher(iter(R_data.SyntheticLM(64, 8, 2, seed=1)))
    for got in batches:
        want = next(ref)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_surfaces_the_iterator_error():
    def bad():
        yield {"x": 1}
        raise KeyError("source failed")

    it = Prefetcher(bad())
    assert next(it) == {"x": 1}
    with pytest.raises(KeyError, match="source failed"):
        next(it)


def _mk_trainer(tmp, **kw):
    built = build_train_step(CFG, SHAPE, make_local_mesh(1, 1, device="cpu"),
                             OptConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                             masked=True)
    state = init_train_state(CFG, built)
    data = iter(SyntheticLM(CFG.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=0))
    tc = TrainerConfig(ckpt_dir=str(tmp), ckpt_every=5, async_ckpt=False, **kw)
    return Trainer(tc, state, built.fn, data,
                   state_shardings=built.in_shardings[0]), built


def _mk_ref_trainer(tmp, **kw):
    built = R_build(R_CFG, R_SHAPE, R_mesh(1, 1),
                    R_Opt(lr=1e-3, warmup_steps=2, total_steps=100),
                    masked=True)
    state = R_init(R_CFG, built)
    data = iter(R_data.SyntheticLM(R_CFG.vocab, R_SHAPE.seq_len,
                                   R_SHAPE.global_batch, seed=0))
    tc = R_TrainerConfig(ckpt_dir=str(tmp), ckpt_every=5, async_ckpt=False,
                         **kw)
    return R_Trainer(tc, state, built.fn, data,
                     state_shardings=built.in_shardings[0])


def test_checkpoint_roundtrip(tmp_path):
    tr, built = _mk_trainer(tmp_path)
    tr.run(6)
    step = ckpt.latest_step(str(tmp_path))
    assert step is not None and step >= 5
    restored, s = ckpt.restore(str(tmp_path), tr.state)
    assert s == step == 6  # the final checkpoint
    assert isinstance(restored, TrainState)
    for field in ("params", "m", "v"):
        got, want = getattr(restored, field), getattr(tr.state, field)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (field, k)
    assert int(restored.step) == int(tr.state.step) == 6
    # an earlier step restores too, onto the step's devices
    restored5, s5 = ckpt.restore(str(tmp_path), tr.state, step=5,
                                 sharding_tree=built.in_shardings[0])
    assert s5 == 5 and int(restored5.step) == 5
    assert all(t.device.type == "cpu" for t in restored5.params.values())


def test_checkpoint_layout_matches_reference(tmp_path):
    """``step_%08d/``, ``META.json`` with the reference's keys, and
    ``leaf_%05d.npy`` files; a NamedTuple's fields are named as JAX names
    them (``.step``, ``.params/...``)."""
    tr, _ = _mk_trainer(tmp_path / "port")
    rtr = _mk_ref_trainer(tmp_path / "ref")
    tr.run(5)
    rtr.run(5)
    metas = []
    for d in (tmp_path / "port", tmp_path / "ref"):
        assert sorted(p.name for p in d.iterdir()) == ["step_00000005"]
        metas.append(json.loads((d / "step_00000005" / "META.json").read_text()))
        files = sorted(p.name for p in (d / "step_00000005").iterdir())
        n = len(metas[-1]["leaves"])
        assert files == ["META.json"] + [f"leaf_{i:05d}.npy" for i in range(n)]
    port, ref = metas
    assert port.keys() == ref.keys() and port["step"] == ref["step"] == 5
    assert {tuple(sorted(e)) for e in port["leaves"]} == \
        {tuple(sorted(e)) for e in ref["leaves"]}
    assert port["leaves"][0] == ref["leaves"][0]  # ".step", int32, shape []
    prefixes = lambda m: [e["name"].split("/")[0] for e in m["leaves"]]
    assert sorted(set(prefixes(port))) == sorted(set(prefixes(ref))) == \
        [".m", ".params", ".step", ".v"]
    # the same parameters: the reference's stacked leaves, per layer
    n_ref = sum(int(np.prod(e["shape"])) for e in ref["leaves"])
    n_port = sum(int(np.prod(e["shape"])) for e in port["leaves"])
    assert n_ref == n_port


def test_async_save_copies_before_the_thread(tmp_path):
    """The device-to-host copy happens before ``save`` returns: an
    in-place update right after it does not reach the checkpoint."""
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": [torch.ones(2)]}
    t = ckpt.save(str(tmp_path), 3, tree, blocking=False)
    tree["a"].add_(100)
    t.join()
    got, step = ckpt.restore(str(tmp_path), tree)
    assert step == 3
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float32))
    assert isinstance(got["b"], list) and torch.equal(got["b"][0], torch.ones(2))


def test_latest_prune_and_errors(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"a": torch.zeros(1)})
    for s in (1, 5, 3, 12):
        ckpt.save(d, s, {"a": torch.full((2,), float(s))})
    assert ckpt.latest_step(d) == 12
    ckpt.prune(d, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000005", "step_00000012"]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, {"a": torch.zeros(2), "b": torch.zeros(2)})
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(d, 13, {"a": torch.zeros(2, dtype=torch.bfloat16)})


def _events(tr):
    """Failure and restore events; straggler events depend on the host's
    timing and are checked on their own below."""
    return [(e["kind"], e["step"]) for e in tr.events
            if e["kind"] in ("failure", "restore")]


def test_failure_injection_restarts(tmp_path):
    """The port's trainer and the reference's, each failing once at step
    7 (after the checkpoint at step 5): the same events, restarts and
    number of logged steps."""
    def boom_once():
        fired = {"n": 0}

        def boom(step):
            if step == 7 and fired["n"] == 0:
                fired["n"] += 1
                raise RuntimeError("injected node failure")
        return boom

    tr, _ = _mk_trainer(tmp_path / "port")
    rtr = _mk_ref_trainer(tmp_path / "ref")
    tr.inject_failure, rtr.inject_failure = boom_once(), boom_once()
    tr.run(10)
    rtr.run(10)
    kinds = [e["kind"] for e in tr.events]
    assert "failure" in kinds and "restore" in kinds
    assert tr.restarts == rtr.restarts == 1
    assert _events(tr) == _events(rtr) == [("failure", 7), ("restore", 5)]
    assert len(tr.metrics_log) == len(rtr.metrics_log) >= 10
    assert [m["step"] for m in tr.metrics_log] == \
        [m["step"] for m in rtr.metrics_log]


def test_failure_without_checkpoint_and_too_many_restarts(tmp_path):
    """No checkpoint yet: the run restarts from its first step; past
    ``max_restarts`` the error propagates.  The reference does both."""
    def always(step):
        if step == 2:
            raise ValueError("bad batch")

    runs = []
    for tr in (_mk_trainer(tmp_path / "port", max_restarts=2)[0],
               _mk_ref_trainer(tmp_path / "ref", max_restarts=2)):
        tr.inject_failure = always
        with pytest.raises(ValueError, match="bad batch"):
            tr.run(4)
        runs.append((_events(tr), tr.restarts,
                     [m["step"] for m in tr.metrics_log]))
    assert runs[0] == runs[1]
    assert runs[0][0] == [("failure", 2)] * 3 and runs[0][1] == 3


def test_straggler_watchdog(tmp_path):
    """One step slowed to at least 5x the median is flagged by both
    trainers (other steps may be flagged by host noise in either)."""
    flagged = []
    for tr in (_mk_trainer(tmp_path / "port", straggler_factor=2.5,
                           straggler_window=10)[0],
               _mk_ref_trainer(tmp_path / "ref", straggler_factor=2.5,
                               straggler_window=10)):
        slow = {"hit": False}
        orig = tr.step_fn

        def maybe_slow(state, batch, tr=tr, slow=slow, orig=orig):
            if len(tr.step_times) == 8 and not slow["hit"]:
                slow["hit"] = True
                time.sleep(max(0.3, 5 * np.median(tr.step_times)))
            return orig(state, batch)

        tr.step_fn = maybe_slow
        seen = []
        tr.on_straggler = lambda step, dt, med: seen.append(step)
        tr.run(12)
        assert any(e["kind"] == "straggler" for e in tr.events)
        steps = [e["step"] for e in tr.events if e["kind"] == "straggler"]
        assert 8 in steps and seen == steps
        flagged.append(8 in steps)
    assert flagged == [True, True]
