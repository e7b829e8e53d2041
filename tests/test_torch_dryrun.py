"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_all``)
against the reference's, as ``tests/test_dryrun_smoke.py`` runs it:
qwen2-0.5b x ``decode_32k`` on the scaled mesh (``REPRO_DRYRUN_SCALE=4``:
(4, 4) single-pod, 16 ranks, and (2, 4, 4) multi-pod, 32), with
``--device cpu``.  Every run is a subprocess of its own (a ``fake``
process group per cell), all started together at module start: the port's
single-pod cell through ``dryrun_all --only``, its multi-pod cell, its
(1, 1) cell at ``REPRO_DRYRUN_SCALE=1`` with ``--save-hlo``, and the
reference's single-pod cell at both scales.

Checks: the JSON key sets equal the reference's, recursively through
``memory``, ``cost``, ``loop_aware`` and ``collectives``; ``chips`` is 16
and 32; ``argument_bytes`` equals the reference's (the same layouts of
the parameters, the cache, the token and ``pos``); per-device FLOPs count
local shards; the sweep records no failure.

Per op class at (1, 1): the port's matmul family equals the reference's
``dot`` FLOPs and its convolutions the reference's ``convolution`` FLOPs,
within rel 1e-12.  The reason: on a one-rank mesh nothing is split, so
each of the step's contractions (the q/k/v/o projections, the MLP, the
attention's scores and values over the whole cache, the LM head) is one
``mm``/``bmm`` in the port and one ``dot`` in the reference's program, of
the same shapes; each count is 2 x M x N x K, an integer far below 2**53,
summed exactly in float64 by both.  Only the order of the sums may differ.
The HBM bytes are not compared: the reference counts XLA's fused program,
the port the unfused one; the test prints the ratio.

Train cells whose backward splits heads unevenly over the model axis, or
meets a Partial gradient in Mamba-1's chunked scan, each a cut of its
model (``tests/torch_dryrun_worker.py``) started with the others:
llama3.2-1b and qwen2-0.5b SMOKE ``train_4k`` at edge 4 (sequence
parallel; 4 and 2 q heads over 4 ways), falcon-mamba-7b SMOKE at edge 16
and phi3.5-moe SMOKE with its 32 q and 8 kv heads (d_model 256) at edge
16 under ZeRO-3, as its production cell runs.  Each must run and write
the reference's JSON keys.

Where the kv heads do not divide the model axis, each rank runs the
attention of its own q heads: qwen2-0.5b ``decode_32k`` at (4, 4) within
1.12x the reference's per-device FLOPs, and the llama3.2-1b cut's
attention products at edge 4 at most a sixteenth of its count at one
rank (a (1, 1) run of the cut, started with the others); the qwen2-0.5b
SMOKE cut's q reaches its train attention replicated and is split on its
heads, so at edge 4 rank 0's attention products are at most 1.02x an
eighth of its count at one rank (1 of 2 q heads on a quarter of the
batch; a (1, 1) run likewise).

The serving prefill splits its dense products and its attention over the
model axis: llama3.2-1b, qwen2-0.5b, falcon-mamba-7b and zamba2-7b at
their published widths, cut to 2 layers over 1,024 tokens at batch 8
(``PREFILL_CUT``), each at edge 4 and at one rank.  Per device at (4, 4)
their dense products (``mm``) are at most 1.02x a sixteenth of the
one-rank count (each row-split product's output is summed before the
residual add, so every later product takes the rank's own columns; the
Mamba mixers take their own d_inner columns of the replicated
``in_proj``; zamba2-7b's Mamba-2 mixers multiply by all 2N columns of B
and C on every rank, 1.026x for ``in_proj`` alone, 1.0076x in all); and
qwen2-0.5b's attention
(``bmm``) runs rank 0's 4 of its 14 q heads on a quarter of the batch (a
replicated q split on its heads).

The train step computes each rank's own share of the weight gradients:
llama3.2-1b at its published widths, cut to 2 layers over 1,024 tokens at
global batch 16, at edge 4, and falcon-mamba-7b at its published widths
and its production ``train_4k`` shape, cut to 2 layers, at edge 16, and
internvl2-2b as llama3.2-1b (``TRAIN_PUBLISHED``), each also at one rank.
Per device their dense products (``mm``) are at most 1.02x the one-rank
count over the ranks: internvl2-2b's head over 92,553 columns, which the
model axis does not divide, runs on each rank's own sequence rows (2.643x
when it ran every row on every model rank).
So are deepseek-moe-16b's, at its published widths cut to 2 layers (one
dense, one MoE) over 1,024 tokens at global batch 32, at edge 4, and its
expert products and attention (``bmm``): each rank routes its own
tokens and runs its own experts on its own capacity slots
(``MOE_PUBLISHED``).  Before, the LM head's weight gradient ran on the
whole vocabulary on every model rank (its gradient came back split on
the sequence, or whole, and falcon-mamba-7b's residual stream reached
the head as a Partial sum): 1.635x at edge 4 for llama3.2-1b and 3.54x
at edge 16 for falcon-mamba-7b."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, SHAPE = "qwen2-0.5b", "decode_32k"
STEM = f"{ARCH}__{SHAPE}"
MATMULS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
           "aten._scaled_mm", "aten._scaled_dot_product_efficient_attention",
           "aten._scaled_dot_product_flash_attention",
           "aten._scaled_dot_product_cudnn_attention"}
# arch: (mesh edge, the cut of its SMOKE config: ModelConfig fields, and
# the train step's ZeRO-3 choice where the production cell makes it)
TRAIN_CUTS = {
    "llama3.2-1b": ("4", {}),
    "qwen2-0.5b": ("4", {}),
    "falcon-mamba-7b": ("16", {}),
    "phi3.5-moe-42b-a6.6b": ("16", dict(n_heads=32, n_kv_heads=8,
                                        d_model=256, fsdp=True)),
}
# its 2 kv heads do not divide the model axis (4): q splits on its heads
HEADS_CUT = "llama3.2-1b"
# its q (2 heads of 32 columns) reaches the attention replicated on the
# model axis (4) and is split on its heads, 1, 1, 0 and 0 a rank
REPLICATED_Q_CUT, REPLICATED_Q_HEADS, REPLICATED_Q_RANK0_HEADS = \
    "qwen2-0.5b", 2, 1
# the prefill's cuts: published widths, 2 layers, a short shape
PREFILL_CUT = dict(published=True, n_layers=2, seq_len=1024, global_batch=8)
PREFILL_ARCHS = ("llama3.2-1b", "qwen2-0.5b", "falcon-mamba-7b", "zamba2-7b")
# qwen2-0.5b: 14 q heads over 2 kv heads, which the model axis (4) does
# not divide; rank 0 holds ceil(14 / 4) of them
QWEN_HEADS, QWEN_RANK0_HEADS = 14, 4
# the train step's cuts at published widths: (mesh edge, cut)
TRAIN_PUBLISHED = {
    "llama3.2-1b": ("4", dict(published=True, n_layers=2, seq_len=1024,
                              global_batch=16)),
    "falcon-mamba-7b": ("16", dict(published=True, n_layers=2)),
    # 92,553 columns, divisible by neither 4 nor 2: the head stays whole
    # and runs on each rank's own sequence rows
    "internvl2-2b": ("4", dict(published=True, n_layers=2, seq_len=1024,
                               global_batch=16)),
}
# the MoE train step's cut at published widths: 2 layers (one dense, one
# MoE) over 1,024 tokens at global batch 32, so that each of the 8
# microbatches (TRAIN_ACC) gives every data rank at edge 4 one whole
# sequence: C = 480 slots of the 4,096 tokens, 120 a data rank, 16 of the
# 64 experts a model rank
MOE_PUBLISHED = ("deepseek-moe-16b", "4", dict(
    published=True, n_layers=2, seq_len=1024, global_batch=32))
CONVS = {"aten.convolution", "aten._convolution", "aten.convolution_backward",
         "aten.cudnn_convolution", "aten.convolution_overrideable",
         "aten._slow_conv2d_forward"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cell = ["--arch", ARCH, "--shape", SHAPE]
    port = [sys.executable, "-m", "repro_torch.launch.dryrun"] + cell
    ref = [sys.executable, "-m", "repro.launch.dryrun"] + cell
    jobs = {
        "sweep": ("4", [sys.executable, "-m", "repro_torch.launch.dryrun_all",
                        "--only", f"{STEM}__single", "--device", "cpu",
                        "--out", str(out / "port4")]),
        "port_multi": ("4", port + ["--mesh", "multi", "--device", "cpu",
                                    "--out", str(out / "port4")]),
        "port1": ("1", port + ["--mesh", "single", "--device", "cpu",
                               "--save-hlo", "--out", str(out / "port1")]),
        "ref4": ("4", ref + ["--mesh", "single", "--out", str(out / "ref4")]),
        "ref1": ("1", ref + ["--mesh", "single", "--save-hlo",
                             "--out", str(out / "ref1")]),
    }
    worker = str(ROOT / "tests" / "torch_dryrun_worker.py")
    for arch, (scale, cut) in TRAIN_CUTS.items():
        jobs[f"cut:{arch}"] = (scale, [
            sys.executable, worker, arch, "train_4k", "single",
            json.dumps(cut), str(out / "cuts")])
    # the q-head splits' cells at one rank: nothing split
    for arch in (HEADS_CUT, REPLICATED_Q_CUT):
        jobs[f"cut1:{arch}"] = ("1", [
            sys.executable, worker, arch, "train_4k", "single",
            json.dumps(TRAIN_CUTS[arch][1]), str(out / "cuts1")])
    for arch in PREFILL_ARCHS:
        for scale, sub in (("4", "pre4"), ("1", "pre1")):
            jobs[f"{sub}:{arch}"] = (scale, [
                sys.executable, worker, arch, "prefill_32k", "single",
                json.dumps(PREFILL_CUT), str(out / sub)])
    for arch, (scale, cut) in TRAIN_PUBLISHED.items():
        for sc, sub in ((scale, "tpub"), ("1", "tpub1")):
            jobs[f"{sub}:{arch}"] = (sc, [
                sys.executable, worker, arch, "train_4k", "single",
                json.dumps(cut), str(out / sub)])
    arch, scale, cut = MOE_PUBLISHED
    for sc, sub in ((scale, "mpub"), ("1", "mpub1")):
        jobs[f"{sub}:{arch}"] = (sc, [
            sys.executable, worker, arch, "train_4k", "single",
            json.dumps(cut), str(out / sub)])
    procs = {}
    for name, (scale, cmd) in jobs.items():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_DRYRUN_SCALE=scale, JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
        procs[name] = subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE)
    logs = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        if name.startswith(("cut", "pre", "tpub", "mpub")):  # each reports
            logs[name] = (p.returncode, stderr)
            continue
        assert p.returncode == 0, f"{name}:\n{stderr[-3000:]}"
        logs[name] = stdout
    return out, logs


def load(runs, sub, mesh="single"):
    out, _ = runs
    return json.loads((out / sub / f"{STEM}__{mesh}.json").read_text())


def key_tree(d):
    """The key set of a JSON object, recursively; a list of objects by the
    keys of its entries."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return [key_tree(d[0])] if d and isinstance(d[0], dict) else []
    return None


@pytest.mark.parametrize("mesh,chips", [("single", 16), ("multi", 32)])
def test_json_has_the_reference_keys_and_chips(runs, mesh, chips):
    port, ref = load(runs, "port4", mesh), load(runs, "ref4")
    assert key_tree(port) == key_tree(ref)
    assert port["chips"] == chips
    assert (port["kind"], port["seq_len"], port["global_batch"],
            port["n_acc"], port["mode"]) == (
        ref["kind"], ref["seq_len"], ref["global_batch"], ref["n_acc"],
        ref["mode"])
    assert port["params"] == ref["params"]
    la = port["loop_aware"]
    assert la["flops"] > 0 and la["bytes_hbm"] > 0
    assert port["memory"]["temp_bytes"] is not None
    assert port["cost"]["flops"] == la["flops"]


def test_argument_bytes_equal_the_reference(runs):
    port, ref = load(runs, "port4"), load(runs, "ref4")
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    assert port["memory"]["alias_bytes"] == ref["memory"]["alias_bytes"]


def test_per_device_flops_count_local_shards(runs):
    """At (4, 4) a device holds a quarter of the batch (data) and, of
    every weight the model axis splits, a quarter: its FLOPs lie between a
    sixteenth and a quarter of the (1, 1) count.  The ratio to the
    reference's is printed (ROADMAP Queue 3 files it by op class)."""
    p4, p1 = load(runs, "port4"), load(runs, "port1")
    r4 = load(runs, "ref4")
    f4, f1 = p4["loop_aware"]["flops"], p1["loop_aware"]["flops"]
    assert f1 / 16 < f4 <= f1 / 4
    multi = load(runs, "port4", "multi")["loop_aware"]["flops"]
    assert multi == pytest.approx(f4 / 2, rel=1e-12)  # the pod axis halves the batch
    print(f"port/reference per-device FLOPs at (4, 4): "
          f"{f4 / r4['loop_aware']['flops']:.4f}")


def test_decode_attention_runs_each_ranks_own_heads(runs):
    """qwen2-0.5b's 2 kv heads do not divide the model axis (4): each rank
    scores its own q heads, ceil(14 / 4) = 4 on this rank, against the
    cache, and projects k/v on its own columns; the reference's program
    splits the same contractions.  Rank 0's 4 of 14 heads put the port at
    1.106x the reference's per-device FLOPs (every head on every rank:
    3.23x)."""
    f4 = load(runs, "port4")["loop_aware"]["flops"]
    r4 = load(runs, "ref4")["loop_aware"]["flops"]
    assert f4 <= 1.12 * r4, f4 / r4


def test_per_op_class_flops_equal_the_reference_at_one_rank(runs,
                                                             monkeypatch):
    from repro.launch import hlo_cost as R

    out, _ = runs
    ops = json.loads((out / "port1" / f"{STEM}__single.ops.json").read_text())
    port_mm = sum(v["flops"] for k, v in ops.items() if k in MATMULS)
    port_conv = sum(v["flops"] for k, v in ops.items() if k in CONVS)
    assert sum(v["flops"] for v in ops.values()) == port_mm + port_conv
    hlo = (out / "ref1" / f"{STEM}__single.hlo.txt").read_text()
    inner = R._instr_flops
    by_class = {}
    for cls in ("dot", "convolution"):
        monkeypatch.setattr(R, "_instr_flops", lambda ins, types, c=cls:
                            inner(ins, types) if ins.op == c else 0.0)
        by_class[cls] = R.analyze(hlo)["flops"]
    assert port_mm == pytest.approx(by_class["dot"], rel=1e-12)
    assert port_conv == pytest.approx(by_class["convolution"], rel=1e-12,
                                      abs=0)
    p1, r1 = load(runs, "port1"), load(runs, "ref1")
    assert p1["loop_aware"]["flops"] == pytest.approx(
        r1["loop_aware"]["flops"], rel=1e-12)
    print(f"port/reference HBM bytes at (1, 1): "
          f"{p1['loop_aware']['bytes_hbm'] / r1['loop_aware']['bytes_hbm']:.4f}")


def test_sweep_records_no_failure(runs):
    out, logs = runs
    assert json.loads((out / "port4" / "_failures.json").read_text()) == []
    assert "done: 1/1 cells OK" in logs["sweep"]


def test_train_attention_runs_each_ranks_own_heads(runs):
    """The llama3.2-1b SMOKE cut at edge 4 (4 q, 2 kv heads; sequence
    parallel): a rank runs a quarter of the batch (data) and one of the 4
    q heads (model), so its attention products (``bmm``) are at most a
    sixteenth of the same cell's at one rank."""
    out, logs = runs
    for name in (f"cut:{HEADS_CUT}", f"cut1:{HEADS_CUT}"):
        rc, stderr = logs[name]
        assert rc == 0, stderr[-3000:]

    def bmm(sub):
        stem = f"{HEADS_CUT}__train_4k__single.ops.json"
        return json.loads((out / sub / stem).read_text())["aten.bmm"]["flops"]

    b4, b1 = bmm("cuts"), bmm("cuts1")
    assert b4 > 0 and 16 * b4 <= b1, b1 / b4


def test_train_attention_splits_a_replicated_q_on_its_heads(runs):
    """The qwen2-0.5b SMOKE cut at edge 4 (2 q heads, 1 kv head; sequence
    parallel): its q reaches the attention replicated on the model axis
    and is split on its heads in the train step too, so rank 0 runs 1 of
    the 2 q heads on its quarter of the batch: its attention products
    (``bmm``) are at most 1.02x an eighth of the same cell's at one rank
    (read 1.0000; with q whole on every rank, a quarter)."""
    out, logs = runs
    for name in (f"cut:{REPLICATED_Q_CUT}", f"cut1:{REPLICATED_Q_CUT}"):
        rc, stderr = logs[name]
        assert rc == 0, stderr[-3000:]
    stem = f"{REPLICATED_Q_CUT}__train_4k__single.ops.json"
    b4, b1 = (json.loads((out / sub / stem).read_text())["aten.bmm"]["flops"]
              for sub in ("cuts", "cuts1"))
    share = b1 / 4 * REPLICATED_Q_RANK0_HEADS / REPLICATED_Q_HEADS
    assert 0 < b4 <= 1.02 * share, b4 / share


@pytest.mark.parametrize("arch", list(TRAIN_CUTS))
def test_train_cells_where_the_backward_splits_unevenly(runs, arch):
    out, logs = runs
    rc, stderr = logs[f"cut:{arch}"]
    assert rc == 0, stderr[-3000:]
    cell = json.loads((out / "cuts" / f"{arch}__train_4k__single.json")
                      .read_text())
    assert key_tree(cell) == key_tree(load(runs, "ref4"))
    edge = int(TRAIN_CUTS[arch][0])
    assert (cell["kind"], cell["chips"]) == ("train", edge * edge)
    assert cell["loop_aware"]["flops"] > 0
    assert cell["cost"]["flops"] == cell["loop_aware"]["flops"]


def prefill_ops(runs, arch):
    """The prefill cut's counted operators at edge 4 and at one rank."""
    out, logs = runs
    ops = []
    for sub in ("pre4", "pre1"):
        rc, stderr = logs[f"{sub}:{arch}"]
        assert rc == 0, stderr[-3000:]
        stem = f"{arch}__prefill_32k__single.ops.json"
        ops.append(json.loads((out / sub / stem).read_text()))
    return ops


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_dense_products_run_on_each_ranks_share(runs, arch):
    """At (4, 4) a rank holds a quarter of the batch and of every
    column- or row-split weight: its dense products are a sixteenth of
    the one-rank count (the LM head over the last token included).  With
    the residual stream left a Partial sum after a row-split product,
    DTensor gathered the next layer's weights and ran those products
    whole (1.155x for llama3.2-1b, 1.103x for qwen2-0.5b); with the Mamba
    mixers' operands laid out by batch alone, every rank multiplied by
    the whole ``in_proj``."""
    ops4, ops1 = prefill_ops(runs, arch)
    mm4, mm1 = ops4["aten.mm"]["flops"], ops1["aten.mm"]["flops"]
    assert mm4 <= 1.02 * mm1 / 16, 16 * mm4 / mm1


def test_prefill_attention_runs_each_ranks_own_q_heads(runs):
    """qwen2-0.5b's q reaches the prefill attention replicated (its 14
    heads do not split 4 ways into whole columns of ``wq``): it is split
    on its heads, rank 0 scoring its 4 of 14 on a quarter of the batch
    (every head: a quarter of the one-rank ``bmm``)."""
    ops4, ops1 = prefill_ops(runs, "qwen2-0.5b")
    b4, b1 = ops4["aten.bmm"]["flops"], ops1["aten.bmm"]["flops"]
    share = b1 / 4 * QWEN_RANK0_HEADS / QWEN_HEADS
    assert 0 < b4 <= share * (1 + 1e-9), b4 / share


@pytest.mark.parametrize("arch", list(TRAIN_PUBLISHED))
def test_train_weight_gradients_run_on_each_ranks_share(runs, arch):
    """At edge e a rank holds 1 / e of the batch and of every weight the
    model axis splits: its dense products, forward, input gradients and
    weight gradients (the LM head's included), are 1 / e**2 of the
    one-rank count."""
    out, logs = runs
    mm = []
    for sub in ("tpub", "tpub1"):
        rc, stderr = logs[f"{sub}:{arch}"]
        assert rc == 0, stderr[-3000:]
        stem = f"{arch}__train_4k__single.ops.json"
        mm.append(json.loads((out / sub / stem).read_text())
                  ["aten.mm"]["flops"])
    ranks = int(TRAIN_PUBLISHED[arch][0]) ** 2
    assert mm[0] <= 1.02 * mm[1] / ranks, ranks * mm[0] / mm[1]


@pytest.mark.parametrize("op", ["aten.mm", "aten.bmm"])
def test_moe_train_runs_each_ranks_own_experts_and_slots(runs, op):
    """At edge 4 a rank routes its own tokens, runs the shared experts on
    them and its own 16 experts on its data rank's 120 of the 480
    capacity slots: its dense products (``mm``: the router, the shared
    and the dense layers, the head) and its batched ones (``bmm``: the
    expert products and the attention) are each at most 1.02x the
    one-rank count over the 16 ranks (read 1.0015 and 1.0000).  On
    gathered tokens every rank ran the shared experts and the router on
    all 4,096 tokens and its experts on all 480 slots: 1.185x and
    3.547x."""
    out, logs = runs
    arch = MOE_PUBLISHED[0]
    flops = []
    for sub in ("mpub", "mpub1"):
        rc, stderr = logs[f"{sub}:{arch}"]
        assert rc == 0, stderr[-3000:]
        stem = f"{arch}__train_4k__single.ops.json"
        flops.append(json.loads((out / sub / stem).read_text())[op]["flops"])
    ranks = int(MOE_PUBLISHED[1]) ** 2
    assert 0 < flops[0] <= 1.02 * flops[1] / ranks, ranks * flops[0] / flops[1]
