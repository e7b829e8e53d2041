"""The chunk loops of the attention and the SSD on local shards
(``dist.sharding.on_local_shards``).

Structure, on ``fake`` process groups of 4 and 8 ranks at (2, 2)
("data", "model") and (2, 2, 2) ("pod", "data", "model") meshes, in this
process: one ``Attention.forward`` (llama3.2-1b SMOKE), one
``mamba2_block`` (zamba2-7b SMOKE) and one ``mamba1_block``
(falcon-mamba-7b SMOKE) on DTensors, with their weights laid out by the
training rules, dispatch as many DTensor-level operators over 8 chunks
as over 2 (a q and KV chunk of 16 over 32 and 128 tokens; the SSD's
256-token chunks over 512 and 2,048), and Mamba-1's over 4 scan chunks
as over 2 (512-token chunks over 1,024 and 2,048 tokens; its conv and
scan on local shards): DTensor lays the operands out once per call, not
once per chunk.  On the (2, 2) mesh a whole ``mamba1_block`` and
``mamba2_block`` (64 tokens), forward and backward, run each rank's own
channels whatever the layout of the gradient handed to their output
(replicated, split by batch or by sequence over the model axis, or a
Partial sum): no all-to-all, and each rank's FLOPs those of the
replicated gradient.

Values, on 4 gloo ranks (``tests/torch_local_shards_worker.py``, started
at module start): the chunked attention split by batch and kv heads, by
the rows of every q chunk (Partial operands that split neither), with
a split sequence, and split by q heads where the model axis cannot
split whole kv-head groups (evenly at (2, 2), 2, 2, 2 and 0 heads at
(1, 4)), and the SSD split by heads and batch with and without
an initial state, each equal to the plain call on the whole tensors
bitwise (every element is computed by the same operations on the same
values); one ``Attention.forward``, one ``mamba2_block`` and one
``mamba1_block`` (over 1,024 tokens, two scan chunks; each rank runs its
own d_inner channels) within 1e-6 x max of the plain modules (their
products sum float32 over other splits);
and the gradients of the attention split by rows (Partial q/k/v) and by
q heads (1e-6 x max: the k/v gradient is a float32 sum over ranks) and
of the SSD (5e-2 x max: each rank's share of
the gradient of A, Bc and Cc is rounded to bfloat16 in its chunks, and
the shares are summed) against the plain call's, and those of a whole
``mamba1_block``'s and a whole ``mamba2_block``'s input and weights
(1e-6 x max, float32 throughout: Mamba-2 over 64 tokens, its scan and
not the SSD) against the plain modules'.
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
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.hlo_cost import Counters
from repro_torch.launch.steps import abstract_model, shard_model
from repro_torch.models import ssm
from repro_torch.models.registry import empty_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {(2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}
BITWISE = ("attention_batch_heads", "attention_partial_rows",
           "attention_sequence", "attention_q_heads",
           "attention_q_heads_uneven", "ssd", "ssd_state")
MODULE_TOL = 1e-6
# layouts, on the (2, 2) mesh, of the gradient handed to a Mamba block's
# output: the train step's backward hands it split by batch over the model
# axis too, by sequence, or as a Partial sum
GRAD_LAYOUTS = {"replicated": (Shard(0), Replicate()),
                "batch": (Shard(0), Shard(0)),
                "sequence": (Shard(0), Shard(1)),
                "partial": (Shard(0), Partial())}
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
@pytest.mark.parametrize("block", ["attention", "mamba2", "mamba1"])
def test_dtensor_operators_do_not_grow_with_the_chunks(fake_mesh, shape,
                                                       block):
    mesh = fake_mesh(shape)
    arch, lengths = {"attention": ("llama3.2-1b", (32, 128)),
                     "mamba2": ("zamba2-7b", (512, 2048)),
                     "mamba1": ("falcon-mamba-7b", (1024, 2048))}[block]
    cfg, model = sharded_model(arch, mesh)
    counts = []
    for S in lengths:
        x = batch_split(torch.zeros(4, S, cfg.d_model), mesh)
        with torch.no_grad(), implicit_replication(), DTensorOps() as c:
            if block == "attention":
                pos = torch.arange(S, dtype=torch.int32)[None].expand(4, S)
                model.blocks[0].attn(x, pos, q_chunk=16, kv_chunk=16)
            else:
                ssm.block_fn(cfg)(cfg, model.blocks[0].ssm, x)
        counts.append(c.n)
    assert counts[0] == counts[1], counts
    assert counts[0] > 0


@pytest.mark.parametrize("layout", list(GRAD_LAYOUTS))
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_mamba_backward_runs_each_ranks_own_channels(fake_mesh, arch,
                                                     layout):
    """Where the model axis divides the mixer's channels, a whole Mamba
    block's forward and backward run each rank's own channels whatever
    the layout of the gradient handed to its output: no all-to-all, and
    each rank's work (the counters of ``launch/hlo_cost.py``) that of a
    gradient replicated over the model axis.  Without
    ``grad_replicated`` on ``out_proj``'s output, Mamba-1 took 9
    all-to-alls for a gradient split by batch and 17 % more work for a
    Partial one; without it on the gated norm's mean, Mamba-2 took 11
    all-to-alls for any of them."""
    mesh = fake_mesh((2, 2))
    cfg, _ = sharded_model(arch, mesh)
    S = 64

    def count(pl):
        _, model = sharded_model(arch, mesh)
        x = batch_split(torch.zeros(4, S, cfg.d_model),
                        mesh).requires_grad_()
        ps = [p.requires_grad_() for p in model.blocks[0].ssm.parameters()]
        if isinstance(pl[1], Partial):
            g = DTensor.from_local(torch.zeros(2, S, cfg.d_model), mesh,
                                   list(pl))
        else:
            g = batch_split(torch.zeros(4, S, cfg.d_model),
                            mesh).redistribute(mesh, list(pl))
        with torch.enable_grad(), implicit_replication(), Counters() as c:
            out = ssm.block_fn(cfg)(cfg, model.blocks[0].ssm, x)[0]
            torch.autograd.grad(out, [x] + ps, grad_outputs=g)
        return c

    got, base = count(GRAD_LAYOUTS[layout]), count(GRAD_LAYOUTS["replicated"])
    assert got.coll["all-to-all"]["count"] == 0, got.coll
    assert got.flops == base.flops, (got.flops, base.flops)


@pytest.mark.parametrize("case", BITWISE)
def test_local_loops_equal_the_plain_call(values, case):
    assert values[case] == 0.0


@pytest.mark.parametrize("case", ["attention_forward", "mamba2_block",
                                  "mamba1_block"])
def test_sharded_modules_equal_the_plain_modules(values, case):
    assert values[case] <= MODULE_TOL


@pytest.mark.parametrize("case,tol", [
    ("attention_partial_rows_grad", MODULE_TOL),
    ("attention_q_heads_grad", MODULE_TOL), ("ssd_grad", SSD_GRAD_TOL),
    ("mamba1_block_grad", MODULE_TOL), ("mamba2_block_grad", MODULE_TOL)])
def test_local_loops_gradients_equal_the_plain_call(values, case, tol):
    """An operand whole on a mesh dimension that splits the others gets a
    Partial gradient: the attention's k/v under a split of the rows or of
    the q heads, the SSD's A (over the data axis) and Bc/Cc (over the
    model axis), Mamba-1's B and C (over the model axis) in its scan,
    Mamba-2's B and C and its gated norm's mean (over the model axis)."""
    assert values[case] <= tol
