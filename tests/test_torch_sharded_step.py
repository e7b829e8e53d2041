"""The port's sharded train step and serving step builders on a 4-rank
DeviceMesh against the reference's on 4 host devices.

At module start two subprocesses run every case (``torch_shard_worker.py``):
the reference on 4 forced host devices and the port on 4 gloo ranks with
JAX blocked, both from one starting state (the reference's
``init_train_state`` on one device, carried by
``carry.state_from_reference``) and the same batches.

Train cases take 2 steps of llama3.2-1b SMOKE at (2, 2) tensor parallel
and sequence parallel, at (1, 4) where ``n_kv_heads`` 2 does not divide
the model axis (the GQA pinning), at (2, 2) with ``fsdp``, and of
deepseek-moe-16b and falcon-mamba-7b SMOKE at (2, 2), deepseek-moe-16b
also with capacity for half its pairs (``moe_drop_2x2``: the second data
rank's pairs dropped because of the first's routing) and with 6
experts at (1, 4), whose hidden size the model axis splits
(``moe_ff_1x4``); then the backward
where heads split unevenly: llama3.2-1b SMOKE, qwen2-0.5b SMOKE (its
q/k/v biases) and a llama cut with 6 q heads (``cut``:
``ModelConfig.with_`` fields) in sequence parallel at (1, 4), the same
cut tensor parallel at (1, 4) (the pinned q split on its own heads, 2,
2, 2 and 0 a rank), and
falcon-mamba-7b SMOKE at (2, 2) over 1,024 tokens (``seq``), where the
scan runs in chunks, and zamba2-7b SMOKE at (2, 2), each rank on its own
Mamba-2 heads; and internvl2-2b SMOKE in sequence parallel at (1, 4) with
a vocabulary of 510, which the model axis does not divide, and 6 image
rows of 32 (``internvl_seq_1x4``: its batches seeded numpy draws of the
reference's ``batch_shapes``, image embeddings and a loss mask
included), where the LM head stays whole and each rank computes the
logits and the loss of its own 8 rows, the image rows inside rank 0's
masked out (``HEAD_ROWS_CASES``: the worker records whether every head
call's logits came out split on their rows).  Tolerances: the
loss within 2e-5 x |ref|, every master, m and v leaf within 1e-4 x max
|ref leaf| (the tolerance of ``test_torch_train_step.py``'s three
one-device steps: each rank sums its own float32 partial products, in an
order neither package fixes), and each state leaf's placements, written
as a ``PartitionSpec`` tuple, equal to the ``.sharding.spec`` of the
reference's output.  Where the reference's own sharded result lies
further than that from its one-device result on the same state and
batches (AdamW divides by sqrt(v), so a gradient entry near zero turns a
last-bit difference of the reduction order into a visible update: the
MoE's ``embed``, 7.6e-4 x max at (2, 2); qwen2's ``bk``, 8.9e-3 x max
at (1, 4), on the entries of its lowest RoPE frequencies, which leave
the scores nearly blind to the key bias), a leaf may differ from the
sharded reference by that spread on top of 1e-4 x max; the worker
reports the spread, and the test prints each leaf it widened.

A spread fitted to one draw does not hold under every float32 reduction
order (qwen2's ``bk`` read 1.83e-2 x max under another torch), so a
master entry may also lie within AdamW's own bound (``adamw_bound``).
The m leaves are held to 1e-4 x max, so the two packages' step
gradients agree to d_t = 1e-4 x max |g_t| over the leaf.  The
reference's worker records m and v before the first step and after each,
and each step's learning rate lr_t (the warmup's, small at steps 1-2);
from them come each step's gradient g_t = (m_t - b1 m_(t-1)) / (1 - b1),
clipped as AdamW takes it, mh_t = m_t / (1 - b1^t) and vh_t = v_t / (1 -
b2^t).  Step t moves an entry by lr_t (r_t + wd p), r_t = mh_t /
(sqrt(vh_t) + eps).  Gradients g_s (s <= t) each moved by at most D_t =
max over s <= t of d_s move mh_t by at most D_t (its weights w_s are
positive and sum to 1) and sqrt(vh_t) by at most D_t (a weighted root
mean square with weights a_s summing to 1: the triangle inequality), so
to first order r_t moves by at most D_t (1 + |r_t|) / (sqrt(vh_t) +
eps).  Whatever the gradients, |r_t| <= C_t = sqrt(sum w_s^2 / a_s)
(Cauchy-Schwarz; C_1 = 1, C_2 = 1.0007), so two runs' r_t differ by at
most 2 C_t, the width of the range of AdamW's updates: the cap, which an
entry whose gradient lies below rounding noise (|g| near 1e-9 against
eps 1e-8) reaches.  The weight decay multiplies an earlier difference by
1 - lr_t wd < 1.  So after T steps an entry lies within the sum over t
of lr_t min(D_t (1 + |r_t|) / (sqrt(vh_t) + eps), 2 C_t) of the
reference's; an entry whose gradient is near its leaf's largest gets
about 2e-4 lr_t a step.  A master entry passes within 1e-4 x max plus the
larger of the spread and its bound; m and v keep 1e-4 x max plus the
spread, and the loss 2e-5 x |ref|.  The test prints, per leaf, the
entries whose bound exceeds the rest of their tolerance, how many of them
needed it, and the largest bound.

Serving cases run ``build_prefill_step`` on a zero cache and then four
``build_decode_step`` steps over that cache, for llama3.2-1b and
whisper-medium SMOKE at (2, 2), in float32 (logits and cache leaves
within 2e-5 x max) and bfloat16 (5e-2 x max), for falcon-mamba-7b,
zamba2-7b and deepseek-moe-16b SMOKE at (2, 2) in float32, and in
float32 at (1, 4): zamba2-7b SMOKE (1 SSM head a rank; its conv's leaves
split 36 a rank against 32 x-channels), and where the 2 kv heads do not
divide the model axis and each rank runs its own q heads, llama3.2-1b
SMOKE (4 q heads, 1 a rank) and the 6-head cut (2, 2, 2 and 0 a rank).
The port's worker records the prefill's layouts: in every serving case
the output of each row-split product (the attention's and the MLP's
``wo``, a Mamba mixer's ``out_proj``) reaches ``summed`` as a Partial
sum, in every layer (the sum that lets the next layer's products take
the rank's own columns), and at (1, 4) every q reaching the chunked
attention is split on its heads (the 6-head cut's q arrives replicated,
6 heads in whole columns of ``wq`` not splitting 4 ways; SMOKE's layer 1
took a Partial q before).  In the
Mamba cases (``SSM_CASES``) the worker records whether each mixer's
``in_proj`` product gave its x split on d_inner over the model axis: so
it must be in every layer, in training and in serving, each rank running
its own channels (Mamba-1) or heads (Mamba-2).  In the MoE cases
(``MOE_CASES``) the worker records each rank's expert block per MoE
layer call: the experts of its model rank (E / 2 at (2, 2); all 6, on
its own hidden columns, in ``moe_ff_1x4``) on its data rank's share of
the capacity slots, in every layer, in training and in serving.

Two layouts that torch 2.11's DTensor rejects (2.13 runs both): in the
train cases ``EMBED_CASES`` the gradient that reaches the embedding's
index holds no Partial placement (the rows' gradient is reduced first),
and in the serving cases ``SPLIT_KV_CASES``, whose model axis splits the
kv heads, every decode attention call runs its scores and values on
local shards, each rank on its own kv heads."""
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.data import pipeline as R_data
from repro.launch.mesh import make_local_mesh as R_mesh
from repro.launch.steps import build_train_step as R_build
from repro.launch.steps import init_train_state as R_init
from repro.models import registry as R_reg
from repro.models.config import ShapeConfig as R_Shape
from repro.optim.adamw import OptConfig as R_Opt
from torch_shard_worker import OPT, with_cut

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL, LEAF_TOL = 2e-5, 1e-4
SERVE_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
SEQ, BATCH = 32, 4
OPT_REF = R_Opt(**OPT)  # the workers' optimizer: b1, b2 and eps

TRAIN = [
    dict(name="llama_tp_2x2", arch="llama3.2-1b", mesh=(2, 2)),
    dict(name="llama_seq_2x2", arch="llama3.2-1b", mesh=(2, 2), mode="seq"),
    dict(name="llama_gqa_1x4", arch="llama3.2-1b", mesh=(1, 4)),
    dict(name="llama_fsdp_2x2", arch="llama3.2-1b", mesh=(2, 2), fsdp=True),
    dict(name="moe_2x2", arch="deepseek-moe-16b", mesh=(2, 2)),
    dict(name="ssm_2x2", arch="falcon-mamba-7b", mesh=(2, 2)),
    # heads that split unevenly over the model axis in the backward: the
    # gradient of the (nkv, g) unflatten (SMOKE, 4 q / 2 kv heads) and of
    # the flatten before ``wo`` (a cut with 6 q heads)
    dict(name="llama_seq_1x4", arch="llama3.2-1b", mesh=(1, 4), mode="seq"),
    dict(name="qwen_seq_1x4", arch="qwen2-0.5b", mesh=(1, 4), mode="seq"),
    dict(name="llama6_seq_1x4", arch="llama3.2-1b", mesh=(1, 4), mode="seq",
         cut=dict(n_heads=6, n_kv_heads=2, d_model=96)),
    # the GQA pinning's q split on its own heads unevenly (2, 2, 2 and 0)
    dict(name="llama6_gqa_1x4", arch="llama3.2-1b", mesh=(1, 4),
         cut=dict(n_heads=6, n_kv_heads=2, d_model=96)),
    # above the scan chunk (512): the chunked scan's write into its first
    # step, whose backward must not meet a Partial gradient
    dict(name="ssm_2x2_1k", arch="falcon-mamba-7b", mesh=(2, 2), seq=1024),
    # the Mamba-2 mixers' backward on each rank's own heads (2 a rank): B
    # and C whole, the gated norm's mean summed over the model axis, the
    # conv's leaves (72 a rank against 64 x-channels) gathered
    dict(name="zamba2_2x2", arch="zamba2-7b", mesh=(2, 2)),
    # capacity for half the pairs: the second data rank's pairs are
    # dropped because of the first's routing, as on one device
    dict(name="moe_drop_2x2", arch="deepseek-moe-16b", mesh=(2, 2),
         cut=dict(moe=dict(capacity_factor=0.5))),
    # 6 experts that the model axis does not divide: it splits their
    # hidden size instead, each rank all experts on its own 16 columns
    dict(name="moe_ff_1x4", arch="deepseek-moe-16b", mesh=(1, 4),
         cut=dict(moe=dict(n_experts=6))),
    # a vocabulary the model axis does not divide (510 over 4): the head
    # stays whole and runs on each rank's own 8 of the 32 rows, the 6
    # image rows inside rank 0's
    dict(name="internvl_seq_1x4", arch="internvl2-2b", mesh=(1, 4),
         mode="seq", cut=dict(vocab=510, n_img_tokens=6)),
]
SERVE = [dict(name=f"{short}_{dtype}", arch=arch, dtype=dtype, mesh=(2, 2))
         for short, arch in (("llama", "llama3.2-1b"),
                             ("whisper", "whisper-medium"))
         for dtype in ("float32", "bfloat16")] + [
    # kv heads that do not divide the model axis: each rank runs its own
    # q heads, 1 a rank (SMOKE, 4 q / 2 kv), and 2, 2, 2 and 0 (6 q / 2 kv)
    dict(name="llama_float32_1x4", arch="llama3.2-1b", dtype="float32",
         mesh=(1, 4)),
    dict(name="llama6_float32_1x4", arch="llama3.2-1b", dtype="float32",
         mesh=(1, 4), cut=dict(n_heads=6, n_kv_heads=2, d_model=96)),
    # the Mamba blocks' residual, and the hybrid's shared block after them
    dict(name="falcon_float32", arch="falcon-mamba-7b", dtype="float32",
         mesh=(2, 2)),
    dict(name="zamba2_float32", arch="zamba2-7b", dtype="float32",
         mesh=(2, 2)),
    # 1 SSM head a rank, and din + 2N = 144 split 36 a rank against 32
    # x-channels: the conv's leaves and state do not line up with the heads
    dict(name="zamba2_float32_1x4", arch="zamba2-7b", dtype="float32",
         mesh=(1, 4)),
    # the MoE layers' prefill and decode, each rank on its own experts
    dict(name="moe_float32", arch="deepseek-moe-16b", dtype="float32",
         mesh=(2, 2)),
]
# the cases whose Mamba mixers run each rank's own channels
SSM_CASES = ("ssm_2x2", "ssm_2x2_1k", "zamba2_2x2", "falcon_float32",
             "zamba2_float32", "zamba2_float32_1x4")
# the layouts torch 2.11 rejects: train cases whose embedding's gradient
# comes back a Partial sum over the model axis, and serving cases whose
# decode splits the kv heads over it
EMBED_CASES = ("llama_tp_2x2", "ssm_2x2", "zamba2_2x2")
SPLIT_KV_CASES = ("llama_float32", "zamba2_float32", "whisper_float32")
# the MoE cases: each rank's expert products on its own (experts, slots)
MOE_CASES = ("moe_2x2", "moe_drop_2x2", "moe_ff_1x4", "moe_float32")
# the head over a vocabulary the model axis does not divide: each rank's
# logits of its own rows
HEAD_ROWS_CASES = ("internvl_seq_1x4",)
# train cases whose q reaches the chunked attention replicated on the
# model axis (2 and 6 heads in columns of ``wq`` that do not split 4 ways
# into whole heads): each rank runs its own q heads, 1, 1, 0 and 0 and
# 2, 2, 2 and 0
Q_HEAD_TRAIN_CASES = ("qwen_seq_1x4", "llama6_seq_1x4")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype != np.int32 else np.asarray(a), tree)


def start_state(arch, seq, batch, cut=None):
    """The reference's one-device initial train state, as numpy."""
    cfg = with_cut(RC.get_config(arch, smoke=True).with_(dtype="float32"),
                   cut)
    built = R_build(cfg, R_Shape("s", "train", seq, batch), R_mesh(1, 1),
                    n_acc=1)
    st = R_init(cfg, built)
    return {"step": np.asarray(st.step), "params": numpy_tree(st.params),
            "m": numpy_tree(st.m), "v": numpy_tree(st.v)}


def train_batches(arch, seq, batch, n, cut=None):
    """``n`` batches of the reference's data pipeline; for the VLM, whose
    batches it cannot make (no ``patch_embeds``), seeded numpy draws of
    the reference's ``batch_shapes`` (a loss mask of about 90 % ones)."""
    cfg = with_cut(RC.get_config(arch, smoke=True), cut)
    if cfg.family != "vlm":
        data = R_data.SyntheticLM(cfg.vocab, seq, batch, seed=0)
        return [data.next_batch() for _ in range(n)]
    rng = np.random.default_rng(5)
    shapes = R_reg.batch_shapes(cfg, R_Shape("s", "train", seq, batch),
                                masked=True)
    out = []
    for _ in range(n):
        b = {}
        for k, (s, _) in shapes.items():
            if k == "patch_embeds":
                b[k] = rng.normal(0, 0.02, s).astype(np.float32)
            elif k == "loss_mask":
                b[k] = (rng.random(s) < 0.9).astype(np.float32)
            else:
                b[k] = rng.integers(0, cfg.vocab, s).astype(np.int32)
        out.append(b)
    return out


def train_cases():
    states = {}
    for c in TRAIN:
        key = (c["arch"], repr(sorted(c.get("cut", {}).items())))
        if key not in states:
            states[key] = start_state(c["arch"], SEQ, BATCH, c.get("cut"))
        seq = c.get("seq", SEQ)
        yield dict(c, kind="train", dtype="float32", seq=seq, batch=BATCH,
                   n_acc=2, state=states[key],
                   batches=train_batches(c["arch"], seq, BATCH, 2,
                                         c.get("cut")))


def serve_cases():
    rng = np.random.default_rng(7)
    for c in SERVE:
        cfg = with_cut(RC.get_config(c["arch"], smoke=True), c.get("cut"))
        params, _ = R_reg.init_model(cfg.with_(dtype="float32"),
                                     jax.random.key(3))
        if cfg.family == "encdec":
            inputs = {"frames": rng.normal(0, 1, (BATCH, SEQ, cfg.d_model))
                      .astype(np.float32)}
            positions = [0, 1, 2, 3]
        else:
            inputs = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ))
                      .astype(np.int32)}
            positions = [20, 21, 22, 23]
        tokens = [rng.integers(0, cfg.vocab, (BATCH, 1)).astype(np.int32)
                  for _ in positions]
        yield dict(c, kind="serve", seq=SEQ, batch=BATCH,
                   params=numpy_tree(params), inputs=inputs, tokens=tokens,
                   positions=positions)


def run_both(cases, tmp_path):
    """Both packages' workers on ``cases``, side by side; their results."""
    inp = tmp_path / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"cases": cases}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    worker = str(ROOT / "tests" / "torch_shard_worker.py")
    procs = {side: subprocess.Popen(
        [sys.executable, worker, side, str(inp), str(tmp_path / f"{side}.pkl")]
        + ([str(free_port())] if side == "port" else []),
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for side in ("ref", "port")}
    out = {}
    for side, p in procs.items():
        # the reference's side runs every case (its one-device steps too):
        # about 140 s alone, and 490 s beside the suite's other workers
        log, _ = p.communicate(timeout=900)
        assert p.returncode == 0, f"{side} worker failed:\n{log[-4000:]}"
        with open(tmp_path / f"{side}.pkl", "rb") as f:
            out[side] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = list(train_cases()) + list(serve_cases())
    return run_both(cases, tmp_path_factory.mktemp("shard"))


def assert_close(got, want, tol, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_close(got[k], want[k], tol, f"{what}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= tol * scale, (what, err, scale)


def pair(results, name):
    ref, port = results["ref"][name], results["port"][name]
    assert "error" not in ref, ref.get("error")
    assert "error" not in port, port.get("error")
    return ref, port


def assert_specs(port_specs, ref_specs):
    """The port's per-layer specs against the reference's stacked leaves,
    whose leading layer axis maps to no mesh axis."""
    from repro_torch.models.carry import STACKED

    for field in ("params", "m", "v"):
        flat = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                ref_specs[field], is_leaf=lambda x: isinstance(x, tuple))[0]:
            flat[tuple(k.key for k in path)] = spec
        for name, got in port_specs[field].items():
            parts = name.split(".")
            if parts[0] in STACKED:
                want = flat[(parts[0],) + tuple(parts[2:])]
                assert not want or want[0] is None, (name, want)
                want = want[1:]
            else:
                want = flat[tuple(parts)]
            assert got == tuple(want), (field, name, got, want)


def adamw_bound(moments, lrs, path):
    """Per entry of the master leaf at ``path``, how far AdamW's steps may
    move it when its gradients are perturbed by ``LEAF_TOL`` x their
    largest entry (the module docstring derives it); ``moments`` holds the
    reference's m and v before the first step and after each, ``lrs``
    each step's learning rate."""
    def leaf(field, t):
        x = moments[t][field]
        for k in path:
            x = x[k.key]
        return np.asarray(x, np.float64)

    b1, b2, eps = OPT_REF.b1, OPT_REF.b2, OPT_REF.eps
    bound, delta = 0.0, 0.0
    for t, lr in enumerate(lrs, 1):
        m_prev, m, v = leaf("m", t - 1), leaf("m", t), leaf("v", t)
        g = (m - b1 * m_prev) / (1 - b1)
        delta = max(delta, LEAF_TOL * float(np.abs(g).max()))
        mhat, s = m / (1 - b1 ** t), np.sqrt(v / (1 - b2 ** t)) + eps
        w = [(1 - b1) * b1 ** (t - j) / (1 - b1 ** t) for j in range(1, t + 1)]
        a = [(1 - b2) * b2 ** (t - j) / (1 - b2 ** t) for j in range(1, t + 1)]
        ratio_max = float(np.sqrt(sum(x * x / y for x, y in zip(w, a))))
        bound = bound + np.minimum(lr * delta * (1 + np.abs(mhat) / s) / s,
                                   2 * lr * ratio_max)
    return bound


def check_train(ref, port):
    for a, b in zip(port["losses"], ref["losses"]):
        assert abs(a - b) <= LOSS_TOL * abs(b), (port["losses"], ref["losses"])
    assert int(port["state"]["step"]) == int(ref["state"]["step"])
    one = ref.get("one_device_state")
    for field in ("params", "m", "v"):
        flat = jax.tree_util.tree_flatten_with_path(ref["state"][field])[0]
        for path, want in flat:
            got, single = port["state"][field], None if one is None else \
                one[field]
            for k in path:
                got = got[k.key]
                single = None if single is None else single[k.key]
            name = f"{field}{jax.tree_util.keystr(path)}"
            scale = max(float(np.abs(want).max()), 1e-30)
            spread = (0.0 if single is None
                      else float(np.abs(want - single).max()))
            if spread > LEAF_TOL * scale:
                print(f"{name}: the reference's sharded vs one-device spread "
                      f"{spread / scale:.3e} x max")
            else:
                spread = 0.0
            err = np.abs(np.asarray(got, np.float64) - want)
            tol = LEAF_TOL * scale + spread
            if field == "params" and "moments" in ref:
                bound = adamw_bound(ref["moments"], ref["lrs"], path)
                wide = bound > tol
                if wide.any():
                    needed = np.flatnonzero(err > tol)
                    print(f"{name}: the AdamW bound widens "
                          f"{int(wide.sum())} of {wide.size} entries, "
                          f"largest {float(bound.max()) / scale:.3e} x max; "
                          f"{needed.size} needed it {needed[:16].tolist()}")
                tol = LEAF_TOL * scale + np.maximum(spread, bound)
            bad = err > tol
            assert not bad.any(), (
                name, float(err.max()) / scale, spread / scale,
                int(bad.sum()), np.flatnonzero(bad)[:8].tolist())
    assert_specs(port["specs"], ref["specs"])


@pytest.mark.parametrize("name", [c["name"] for c in TRAIN])
def test_train_steps_match_reference(results, name):
    ref, port = pair(results, name)
    assert port["n_acc"] == ref["n_acc"] == 2
    check_train(ref, port)


@pytest.mark.parametrize("name", [c["name"] for c in SERVE])
def test_serving_steps_match_reference(results, name):
    ref, port = pair(results, name)
    tol = SERVE_TOL[next(c["dtype"] for c in SERVE if c["name"] == name)]
    assert_close(port["prefill_logits"], ref["prefill_logits"], tol,
                 "prefill logits")
    assert_close(port["prefill_cache"], ref["prefill_cache"], tol,
                 "prefill cache")
    for i, (a, b) in enumerate(zip(port["decode_logits"],
                                   ref["decode_logits"])):
        assert_close(a, b, tol, f"decode logits {i}")
    assert_close(port["decode_cache"], ref["decode_cache"], tol,
                 "decode cache")


def row_split_products(case) -> int:
    """The row-split products a prefill of ``case`` runs: two a
    transformer block (an encoder block for whisper: its prefill runs
    only the encoder), one a Mamba block, two at each of the hybrid's
    shared-block call sites."""
    cfg = with_cut(RC.get_config(case["arch"], smoke=True), case.get("cut"))
    if cfg.family == "encdec":
        return 2 * cfg.n_enc_layers
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers + 2 * -(-cfg.n_layers // cfg.attn_every)
    return 2 * cfg.n_layers


@pytest.mark.parametrize("name", [c["name"] for c in SERVE])
def test_serving_prefill_sums_row_split_products(results, name):
    """Each block sums the output of its row-split products before the
    residual add (``summed``): every one, in every layer, is a Partial
    sum there."""
    _, port = pair(results, name)
    flags = port["summed_partial"]
    case = next(c for c in SERVE if c["name"] == name)
    assert len(flags) == row_split_products(case), flags
    assert all(flags), flags


@pytest.mark.parametrize("name", [c["name"] for c in SERVE
                                  if c["mesh"] == (1, 4)
                                  and c["arch"] == "llama3.2-1b"])
def test_serving_prefill_splits_q_on_its_heads(results, name):
    """At (1, 4) the 2 kv heads do not divide the model axis: in every
    layer's prefill attention each rank runs its own q heads."""
    _, port = pair(results, name)
    split = [s for _, s in port["q_heads"]]
    assert split == [True, True], port["q_heads"]


@pytest.mark.parametrize("name", SSM_CASES)
def test_mamba_mixers_run_each_ranks_own_channels(results, name):
    """The model axis divides d_inner (Mamba-1) and the SSM heads
    (Mamba-2): in every layer, in training (each microbatch, and its
    recompute) and in serving (the prefill and each decode step), the
    ``in_proj`` product's x output is split on d_inner over the model
    axis."""
    _, port = pair(results, name)
    flags = port["ssm_by_channel"]
    case = next(c for c in TRAIN + SERVE if c["name"] == name)
    layers = RC.get_config(case["arch"], smoke=True).n_layers
    if case in SERVE:  # the prefill and 4 decode steps
        assert len(flags) == 5 * layers, flags
    else:  # 2 steps of 2 microbatches, and the recompute
        assert len(flags) % layers == 0 and len(flags) >= 4 * layers, flags
    assert all(flags), flags


@pytest.mark.parametrize("name", EMBED_CASES)
def test_embedding_gradient_holds_no_partial_sum(results, name):
    """The gradient handed to the embedding's row read (each microbatch
    of both steps) is laid out as the rows: Shard or Replicate on every
    mesh dimension, a local tensor for the read's own backward (torch
    2.11's DTensor ``aten.index_put`` rejects split indices)."""
    _, port = pair(results, name)
    flags = port["embed_grad_partial"]
    assert len(flags) == 4 and not any(flags), flags


@pytest.mark.parametrize("name", SPLIT_KV_CASES)
def test_split_kv_decode_runs_on_local_shards(results, name):
    """Each decode step's attention, in every attention layer (every
    call site of the hybrid's shared block; whisper's self and cross
    attention), runs on local shards, each rank on its own kv heads."""
    from repro_torch.models.transformer import hybrid_attn_layers

    _, port = pair(results, name)
    case = next(c for c in SERVE if c["name"] == name)
    cfg = RC.get_config(case["arch"], smoke=True)
    if cfg.family == "hybrid":
        layers = hybrid_attn_layers(cfg)
    elif cfg.family == "encdec":
        layers = 2 * cfg.n_dec_layers
    else:
        layers = cfg.n_layers
    local = (True, cfg.n_kv_heads // case["mesh"][1])
    assert port["decode_kv_local"] == [local] * (4 * layers), \
        port["decode_kv_local"]


@pytest.mark.parametrize("name", HEAD_ROWS_CASES)
def test_head_runs_on_each_ranks_own_rows(results, name):
    """The model axis does not divide the vocabulary, so the head's
    columns stay whole: every head call (each microbatch of both steps)
    gives logits split on their rows (Shard(1)) over the model axis, each
    rank's logits of its own rows."""
    _, port = pair(results, name)
    flags = port["head_rows"]
    assert len(flags) == 4 and all(flags), flags


@pytest.mark.parametrize("name", Q_HEAD_TRAIN_CASES)
def test_train_splits_a_replicated_q_on_its_heads(results, name):
    """Every q reaching the chunked attention in these train steps (each
    microbatch of both steps, and its recompute, in every layer) arrives
    replicated on the model axis and leaves ``split_q_heads`` split on its
    heads: each rank runs the attention of its own q heads, its gradient
    a Partial share (``dist.sharding.own_heads``), as the reference pins q
    on its heads."""
    _, port = pair(results, name)
    seen = port["q_heads"]
    case = next(c for c in TRAIN if c["name"] == name)
    layers = with_cut(RC.get_config(case["arch"], smoke=True),
                      case.get("cut")).n_layers
    assert len(seen) % layers == 0 and len(seen) >= 4 * layers, seen
    assert all(s == ("R", True) for s in seen), seen


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_experts_run_each_ranks_own_block(results, name):
    """In every MoE layer call, in training (each microbatch, and its
    recompute) and in serving (the prefill and each decode step), each
    rank's expert products run on its own block: the experts of its
    model rank (E / 2 at (2, 2); all 6 at (1, 4), which splits their
    hidden size) on its data rank's share of the capacity C, ceil(C /
    data) slots a data rank and the rest on the last (a mesh (data,
    model), rank = model x data + model rank)."""
    from repro_torch.models.moe import capacity

    _, port = pair(results, name)
    case = next(c for c in TRAIN + SERVE if c["name"] == name)
    cfg = with_cut(RC.get_config(case["arch"], smoke=True), case.get("cut"))
    E, d = cfg.moe.n_experts, cfg.d_model
    data, model = case["mesh"]
    experts = E // model if E % model == 0 else E
    layers = cfg.n_layers - cfg.moe.first_dense_layers  # the MoE layers
    if case in SERVE:  # the prefill, then 4 decode steps of one token
        tokens = [BATCH * SEQ] * layers + [BATCH] * (4 * layers)
    else:  # per microbatch of 2 sequences, forward and recompute alike
        tokens = None
    for rank, blocks in enumerate(port["expert_blocks"]):
        if tokens is None:
            assert len(blocks) % layers == 0 and len(blocks) >= 4 * layers, \
                blocks
        want = []
        for T in tokens or [2 * case.get("seq", SEQ)] * len(blocks):
            C = capacity(cfg, T)
            step = -(-C // data)
            c0 = min(rank // model * step, C)
            want.append((experts, min(c0 + step, C) - c0, d))
        assert blocks == want, (rank, blocks, want)


def test_moe_capacity_drops_the_other_data_ranks_pairs(results):
    """``moe_drop_2x2``'s capacity (factor 0.5) holds half the pairs:
    every call drops pairs of the second data rank's tokens, which the
    first's fill the buffers before (the token-major count of the whole
    call), and the port still matches the reference
    (``test_train_steps_match_reference``)."""
    _, port = pair(results, "moe_drop_2x2")
    dropped = port["moe_dropped"]
    assert dropped and all(second > 0 for _, second in dropped), dropped
