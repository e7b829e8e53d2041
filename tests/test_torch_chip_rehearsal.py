"""``chip_smoke.py``'s phases 12 to 15 rehearsed on the CPU at SMOKE size:
the functions the card runs at full width (the SSM and hybrid engines
under load with their checks (a) and (b), whisper's streams and its host
check; the training launcher with its injected failure, the card-vs-CPU
cut, and llama3.2-1b's trainer, checkpoint and compression; the mesh
path's sharded train step and serving builders on a gloo group of one
rank; the dry runs at edge 4 and the cost model's count of a decode step
on real against fake tensors), with ``device="cpu"``, so that a fault in
the script shows before a chip run.  Device metrics (launches per tick,
peak memory) are None here."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LOAD = dict(device="cpu", smoke=True, requests=6, max_new=6, slots=2,
            max_len=64, prompt_lens=(4, 24), long_prefill=1024)


@pytest.mark.parametrize("arch", cs.SSM_ARCHS)
def test_phase12_ssm_serving_and_checks(arch):
    stats = cs.ssm_serving_phase("cpu", arch, **LOAD)
    assert stats["generated_tokens"] == 36
    assert stats["batch1_steps"] == [6] * cs.GREEDY_CHECKS
    assert stats["launches_per_tick"] is None
    assert 0 < stats["decode_bound_ms"] < stats["decode_step_ms_p50"]
    host = cs.ssm_host_phase("cpu", arch, device="cpu", smoke=True)
    assert sorted(host) == list(cs.SSM_HOST_LENS)
    for S, res in host.items():
        assert res["greedy_steps"] == cs.SSM_HOST_DECODE
        chunked = arch == "zamba2-7b" and S == 4096
        assert (res["tol"], res["leaf_tol"]) == (
            (cs.SSD_LOGITS_TOL, cs.SSD_LEAF_TOL) if chunked else (1e-3, 1e-3))
        assert ("attn.k" in res["states"]) == (arch == "zamba2-7b")


def test_phase12_whisper_streams_and_host_check():
    stats = cs.whisper_phase("cpu", device="cpu", smoke=True, streams=2,
                             frames=48, steps=10, self_len=64)
    assert stats["params"] == 203_008
    assert stats["greedy_steps"] == 10
    assert stats["enc_max_abs_err"] <= 1e-3 * stats["enc_max"]


def test_phase13_launcher_and_failure_injection(tmp_path):
    from repro_torch.kernels.minplus import batched as tk

    launches = cs.train_launcher_phase(tk, "cpu", tmp_path, device="cpu")
    assert sorted(launches) == sorted(cs.TRAIN_ARCHS)
    assert set(launches.values()) == {0}  # the plain path launches nothing
    cs.train_step_phase("cpu", device="cpu")


def test_phase13_host_cut_and_llama_trainer(tmp_path):
    cut = cs.train_host_phase("cpu", device="cpu", smoke=True)
    assert cut == dict(loss_rel_err=0.0, grad_err=0.0, update_err=0.0)
    stats = cs.llama_train_phase("cpu", tmp_path, device="cpu", smoke=True)
    assert stats["steps"] == len(stats["losses"]) == cs.TRAIN_STEPS
    assert stats["peak_device_bytes"] is None
    assert stats["compress_max_err_over_scale"] <= 1.0
    assert not (tmp_path / "build" / "chip_smoke_train" / "llama_full").exists()


def test_phase14_mesh_path_at_world_size_one():
    """(a) the sharded step == the one-device step, bitwise; (b) the
    builders == the direct calls, bitwise, and the float32 cut."""
    train = cs.sharded_train_phase("cpu", device="cpu", smoke=True)
    assert train["leaves_not_bitwise"] == []
    assert train["losses"]["mesh"] == train["losses"]["one_device"]
    assert len(train["losses"]["mesh"]) == cs.SHARD_STEPS
    serve = cs.sharded_serve_phase("cpu", device="cpu", smoke=True)
    assert serve["peak_device_bytes"] is None
    assert serve["decode_steps"] == 4
    assert max(serve["cut_errs"]) == 0.0


def test_phase15_dry_runs_and_cost_model():
    """(a) both meshes' dry runs at edge 4 (16 and 32 fake ranks) in
    subprocesses; (b) the cost model on real CPU tensors equal to its count
    on fake ones, with the bound beside a p50 handed in."""
    cells = cs.dryrun_cells("cpu", ROOT, device="cpu", scale=4)
    assert [cells[m]["chips"] for m in cs.DRYRUN_MESHES] == [16, 32]
    assert cells["single"]["argument_bytes"] == 13_131_984_260
    assert cells["multi"]["flops"] == cells["single"]["flops"] / 2
    cost = cs.cost_model_phase("cpu", 1.0, device="cpu", smoke=True)
    assert cost["flops"] > 0 and cost["bytes_hbm"] > 0
    assert cost["bound_ms"] == max(cost["flops_ms"], cost["bytes_ms"])
    assert cost["memory"]["alias_bytes"] > 0  # the cache, written in place
