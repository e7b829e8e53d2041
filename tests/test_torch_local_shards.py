"""The chunk loops of the attention and the SSD on local shards
(``dist.sharding.on_local_shards``).

Structure, on ``fake`` process groups of 4 and 8 ranks at (2, 2)
("data", "model") and (2, 2, 2) ("pod", "data", "model") meshes, in this
process: one ``Attention.forward`` (llama3.2-1b SMOKE) and one
``mamba2_block`` (zamba2-7b SMOKE) on DTensors, with their weights laid
out by the training rules, dispatch as many DTensor-level operators over
8 chunks as over 2 (a q and KV chunk of 16 over 32 and 128 tokens; the
SSD's 256-token chunks over 512 and 2,048): DTensor lays the operands
out once per call, not once per chunk.

Values, on 4 gloo ranks (``tests/torch_local_shards_worker.py``, started
at module start): the chunked attention split by batch and kv heads, by
the rows of every q chunk (Partial operands that split neither), with
a split sequence, and split by q heads where the model axis cannot
split whole kv-head groups (evenly at (2, 2), 2, 2, 2 and 0 heads at
(1, 4)), and the SSD split by heads and batch with and without
an initial state, each equal to the plain call on the whole tensors
bitwise (every element is computed by the same operations on the same
values); one ``Attention.forward`` and one ``mamba2_block`` within 1e-6 x
max of the plain modules (their products sum float32 over other splits);
and the gradients of the attention split by rows (Partial q/k/v) and by
q heads (1e-6 x max: the k/v gradient is a float32 sum over ranks) and
of the SSD (5e-2 x max: each rank's share of
the gradient of A, Bc and Cc is rounded to bfloat16 in its chunks, and
the shares are summed) against the plain call's.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.steps import abstract_model, shard_model
from repro_torch.models import ssm
from repro_torch.models.registry import empty_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {(2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}
BITWISE = ("attention_batch_heads", "attention_partial_rows",
           "attention_sequence", "attention_q_heads",
           "attention_q_heads_uneven", "ssd", "ssd_state")
MODULE_TOL = 1e-6
SSD_GRAD_TOL = 5e-2  # its chunks compute in bfloat16 (``ssm._ssd``)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def values(tmp_path_factory):
    out = tmp_path_factory.mktemp("local_shards") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_local_shards_worker.py"),
         str(free_port()), str(out)], env=env, capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape):
        if dist.is_initialized():
            dist.destroy_process_group()
        n = 1
        for s in shape:
            n *= s
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        return init_device_mesh("cpu", shape, mesh_dim_names=MESHES[shape])

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


class DTensorOps(TorchDispatchMode):
    """Counts the operators dispatched on DTensors (and lets DTensor run
    them)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self.n += 1
            return NotImplemented
        return func(*args, **(kwargs or {}))


def sharded_model(arch, mesh):
    cfg = get_config(arch, smoke=True)
    shapes, axes = abstract_model(cfg)
    model = shard_model(empty_model(cfg, "cpu"), shd.tree_shardings(
        shd.train_compute_rules(mesh), shapes, axes))
    return cfg, model


def batch_split(x, mesh):
    return distribute_tensor(x, mesh, [Shard(0)] * (mesh.ndim - 1)
                             + [Replicate()])


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("block", ["attention", "mamba2"])
def test_dtensor_operators_do_not_grow_with_the_chunks(fake_mesh, shape,
                                                       block):
    mesh = fake_mesh(shape)
    arch = "llama3.2-1b" if block == "attention" else "zamba2-7b"
    cfg, model = sharded_model(arch, mesh)
    counts = []
    for S in ((32, 128) if block == "attention" else (512, 2048)):
        x = batch_split(torch.zeros(4, S, cfg.d_model), mesh)
        with torch.no_grad(), implicit_replication(), DTensorOps() as c:
            if block == "attention":
                pos = torch.arange(S, dtype=torch.int32)[None].expand(4, S)
                model.blocks[0].attn(x, pos, q_chunk=16, kv_chunk=16)
            else:
                ssm.mamba2_block(cfg, model.blocks[0].ssm, x)
        counts.append(c.n)
    assert counts[0] == counts[1], counts
    assert counts[0] > 0


@pytest.mark.parametrize("case", BITWISE)
def test_local_loops_equal_the_plain_call(values, case):
    assert values[case] == 0.0


@pytest.mark.parametrize("case", ["attention_forward", "mamba2_block"])
def test_sharded_modules_equal_the_plain_modules(values, case):
    assert values[case] <= MODULE_TOL


@pytest.mark.parametrize("case,tol", [
    ("attention_partial_rows_grad", MODULE_TOL),
    ("attention_q_heads_grad", MODULE_TOL), ("ssd_grad", SSD_GRAD_TOL)])
def test_local_loops_gradients_equal_the_plain_call(values, case, tol):
    """An operand whole on a mesh dimension that splits the others gets a
    Partial gradient: the attention's k/v under a split of the rows or of
    the q heads, the SSD's A (over the data axis) and Bc/Cc (over the
    model axis)."""
    assert values[case] <= tol
