"""``chip_smoke.py``'s phase 12 rehearsed on the CPU at SMOKE size: the
functions the card runs at full width (the SSM and hybrid engines under
load with their checks (a) and (b), whisper's streams and its host check),
with ``device="cpu"``, so that a fault in the script shows before a chip
run.  Device metrics (launches per tick, peak memory) are None here."""
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
