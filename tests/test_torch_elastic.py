"""Elastic training on the port's DeviceMesh against the reference's
(``tests/test_runtime.py::test_elastic_reshard``): a checkpoint saved from
a 4-rank (4, 1) mesh restored onto a 2-rank (2, 1) mesh, and
``Trainer.resize`` from (4, 1) onto (2, 2), each followed by a step.

The port runs on 4 gloo ranks (ranks 2 and 3 sit out the 2-rank mesh),
the reference on 4 forced host devices (``torch_shard_worker.py``), from
one starting state and the same batches.  The losses must agree within
2e-5 x |ref|, every master, m and v leaf within 1e-4 x max (see
``test_torch_sharded_step.py`` for why), and each leaf's placements with
the reference's spec; ``resize`` must leave every leaf's ``full_tensor()``
bitwise as it was."""
import pytest

import test_torch_sharded_step as S

CASES = [dict(name="restore_4x1_to_2x1", kind="restore"),
         dict(name="resize_4x1_to_2x2", kind="resize")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    arch = "llama3.2-1b"
    state = S.start_state(arch, S.SEQ, S.BATCH)
    batches = S.train_batches(arch, S.SEQ, S.BATCH, 2)
    cases = [dict(c, arch=arch, dtype="float32", seq=S.SEQ, batch=S.BATCH,
                  n_acc=2, state=state, batches=batches) for c in CASES]
    return S.run_both(cases, tmp_path_factory.mktemp("elastic"))


def test_restore_onto_a_smaller_mesh_matches_reference(results):
    ref, port = S.pair(results, "restore_4x1_to_2x1")
    assert port["restored_step"] == ref["restored_step"] == 1
    S.check_train(ref, port)


def test_resize_keeps_every_leaf_and_the_next_step_matches(results):
    ref, port = S.pair(results, "resize_4x1_to_2x2")
    assert port["resize_bitwise"]
    assert port["resize_events"] == ["resize"]
    S.assert_specs(port["resize_specs"], ref["specs"])
    S.check_train(ref, port)
