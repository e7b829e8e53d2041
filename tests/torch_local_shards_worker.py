"""The chunk loops on local shards against the plain call, on a (2, 2)
("data", "model") mesh of 4 gloo ranks.

    python tests/torch_local_shards_worker.py PORT OUT

Joins 4 ranks on ``tcp://127.0.0.1:PORT`` (JAX blocked), runs each case
on DTensors and on the whole plain tensors, and rank 0 writes {case: the
largest absolute difference of the gathered outputs} to ``OUT`` as JSON.

Cases: the chunked attention (``attention._chunked_attention``) with q,
k and v split by batch and kv heads, as Partial sums that split neither
(so by the rows of every q chunk, each rank at its own offset), with
the sequence split (gathered once), and with q split on its own heads
where the model axis cannot split whole kv-head groups (k and v whole:
6 q / 3 kv heads at (2, 2), runs of a rank's heads that read two kv
heads; 6 q / 2 kv heads at (1, 4), 2, 2, 2 and 0 heads a rank, also
with gradients); the SSD (``ssm._ssd_chunked``) with
``dt`` and ``A`` split by heads, the rest by batch, with and without an
initial state; one ``Attention.forward`` (llama3.2-1b SMOKE), one
``mamba2_block`` (zamba2-7b SMOKE) and one ``mamba1_block``
(falcon-mamba-7b SMOKE, 1,024 tokens) with their weights laid out by the
training rules, against the same modules on plain tensors; and the
gradients of the chunked attention split by rows (Partial q/k/v, every
rank's share) and by q heads at (1, 4), of the SSD at (2, 2), and of the
input and weights of a ``mamba1_block`` and a ``mamba2_block`` (64
tokens), against the plain call's.
"""
import json
import sys


def rank_main(rank, port, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import abstract_model, shard_model
    from repro_torch.models import attention as att
    from repro_torch.models import ssm
    from repro_torch.models.common import draw_weights
    from repro_torch.models.registry import empty_model

    torch.set_num_threads(1)
    torch.set_grad_enabled(False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    found = {}

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    def put(t, *pl):
        return distribute_tensor(t, mesh, list(pl))

    def err(got, want):
        got = got.full_tensor() if isinstance(got, DTensor) else got
        return float((got.double() - want.double()).abs().max())

    def attention(name, B, nq, nkv, pl, S=64, chunk=16, kv_pl=None,
                  on=mesh):
        q, k, v = rnd(B, S, nq, 8), rnd(B, S, nkv, 8), rnd(B, S, nkv, 8)
        want = att._chunked_attention(q, k, v, causal=True, q_chunk=chunk,
                                      kv_chunk=chunk)
        if kv_pl is not None:  # q and k/v laid out apart
            ts = [distribute_tensor(t, on, list(p))
                  for t, p in ((q, pl), (k, kv_pl), (v, kv_pl))]
        elif pl == "partial":  # the model axis' rank 0 holds the sum
            m = mesh.get_coordinate()[1]
            ts = [DTensor.from_local(
                (t if m == 0 else torch.zeros_like(t)).chunk(2)[
                    mesh.get_coordinate()[0]].contiguous(),
                mesh, [Shard(0), Partial()], run_check=False)
                for t in (q, k, v)]
        else:
            ts = [put(t, *pl) for t in (q, k, v)]
        with implicit_replication():
            got = att._chunked_attention(*ts, causal=True, q_chunk=chunk,
                                         kv_chunk=chunk)
        found[name] = err(got, want)

    attention("attention_batch_heads", 4, 4, 2, (Shard(0), Shard(2)))
    attention("attention_partial_rows", 2, 2, 1, "partial")
    attention("attention_sequence", 4, 4, 2, (Shard(0), Shard(1)))
    B, S, nh, hp, N = 4, 512, 4, 8, 16
    dt = torch.nn.functional.softplus(rnd(B, S, nh))
    A = -torch.exp(rnd(nh))
    xh, Bc, Cc = (rnd(B, S, nh, hp, dtype=torch.bfloat16),
                  rnd(B, S, N, dtype=torch.bfloat16),
                  rnd(B, S, N, dtype=torch.bfloat16))
    for name, h0 in (("ssd", None), ("ssd_state", rnd(B, nh, hp, N))):
        want = ssm._ssd_chunked(dt, A, xh, Bc, Cc, h0, 256)
        args = (put(dt, Shard(0), Shard(2)), put(A, Replicate(), Shard(0)),
                put(xh, Shard(0), Replicate()), put(Bc, Shard(0), Replicate()),
                put(Cc, Shard(0), Replicate()),
                None if h0 is None else put(h0, Shard(0), Shard(1)))
        with implicit_replication():
            got = ssm._ssd_chunked(*args, 256)
        found[name] = max(err(g, w) for g, w in zip(got, want))
    # whole modules, weights on the training rules' layout
    modules = {}
    for arch, S in (("llama3.2-1b", 64), ("zamba2-7b", 512),
                    ("falcon-mamba-7b", 1024)):
        cfg = get_config(arch, smoke=True)
        plain = draw_weights(empty_model(cfg, "cpu"),
                             torch.Generator().manual_seed(1))
        shapes, axes = abstract_model(cfg)
        sharded = empty_model(cfg, "cpu")
        sharded.load_state_dict(plain.state_dict())
        shard_model(sharded, shd.tree_shardings(
            shd.train_compute_rules(mesh), shapes, axes))
        x = rnd(4, S, cfg.d_model)
        if arch == "llama3.2-1b":
            pos = torch.arange(S, dtype=torch.int32)[None].expand(4, S)
            want = plain.blocks[0].attn(x, pos, q_chunk=16, kv_chunk=16)[0]
            with implicit_replication():
                got = sharded.blocks[0].attn(
                    put(x, Shard(0), Replicate()), pos, q_chunk=16,
                    kv_chunk=16)[0]
            name = "attention_forward"
        else:
            name = ssm.block_fn(cfg).__name__
            want = ssm.block_fn(cfg)(cfg, plain.blocks[0].ssm, x)[0]
            with implicit_replication():
                got = ssm.block_fn(cfg)(cfg, sharded.blocks[0].ssm,
                                        put(x, Shard(0), Replicate()))[0]
            modules[name] = (cfg, plain, sharded, x)
        found[name] = err(got, want) / float(want.abs().max())

    # (drawn after the cases above, whose draws stay as they were)
    # q split on its own heads where the model axis cannot split whole
    # kv-head groups: 6 q heads over 2 ranks, 3 a rank, which read 2 kv
    # heads each (3 kv heads, 2 q heads each); and 6 q / 2 kv heads over
    # a (1, 4) mesh: 2, 2, 2 and 0 q heads
    attention("attention_q_heads", 4, 6, 3, (Shard(0), Shard(2)),
              kv_pl=(Shard(0), Replicate()))
    row = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    attention("attention_q_heads_uneven", 2, 6, 2, (Replicate(), Shard(2)),
              kv_pl=(Replicate(), Replicate()), on=row)

    def grads(fn, plain, placed, on=mesh):
        """The gradients of sum(fn(*ts) * w), w a fixed draw, of the plain
        tensors and of the same laid out on ``placed``, the largest
        difference over the largest plain gradient."""
        with torch.enable_grad():
            ts = [t.clone().requires_grad_() for t in plain]
            out = fn(*ts)
            ws = [rnd(*o.shape) for o in out]
            want = torch.autograd.grad(
                sum((o.float() * w).sum() for o, w in zip(out, ws)), ts)
            ds = [distribute_tensor(t, on, list(pl)).requires_grad_()
                  for t, pl in zip(plain, placed)]
            with implicit_replication():
                out = fn(*ds)
                got = torch.autograd.grad(sum(
                    (o.float() * distribute_tensor(w, on, list(o.placements))
                     ).sum() for o, w in zip(out, ws)), ds)
        return max(err(g, w) / float(w.abs().max())
                   for g, w in zip(got, want))

    # Partial q/k/v (split by the rows of each q chunk): each rank's k/v
    # gradient covers its own rows, a Partial sum over the model axis; the
    # gradient of a rank's share of a Partial input is the whole one
    with torch.enable_grad():
        plain = (rnd(2, 64, 2, 8), rnd(2, 64, 1, 8), rnd(2, 64, 1, 8))
        w = rnd(2, 64, 2, 8)
        ts = [t.clone().requires_grad_() for t in plain]
        want = torch.autograd.grad((att._chunked_attention(
            *ts, causal=True, q_chunk=16, kv_chunk=16) * w).sum(), ts)
        d, m = mesh.get_coordinate()
        shares = [(t if m == 0 else torch.zeros_like(t)).chunk(2)[d]
                  .contiguous().requires_grad_() for t in plain]
        with implicit_replication():
            out = att._chunked_attention(
                *(DTensor.from_local(t, mesh, [Shard(0), Partial()],
                                     run_check=False) for t in shares),
                causal=True, q_chunk=16, kv_chunk=16)
            got = torch.autograd.grad(
                (out * put(w, Shard(0), Replicate())).sum().full_tensor(),
                shares)
    worst = torch.tensor(max(
        float((g - wt.chunk(2)[d]).abs().max() / wt.abs().max())
        for g, wt in zip(got, want)))
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    found["attention_partial_rows_grad"] = float(worst)

    # the backward of the q-head split: each rank's k/v gradient is a
    # Partial sum over the model axis (uneven, 2, 2, 2 and 0 heads)
    found["attention_q_heads_grad"] = grads(
        lambda q, k, v: (att._chunked_attention(q, k, v, causal=True,
                                                q_chunk=16, kv_chunk=16),),
        (rnd(2, 64, 6, 8), rnd(2, 64, 2, 8), rnd(2, 64, 2, 8)),
        ((Replicate(), Shard(2)), (Replicate(), Replicate()),
         (Replicate(), Replicate())), on=row)

    # the SSD's backward: A, Bc and Cc are whole on a mesh dimension that
    # splits the others (batch, heads), so their gradients are Partial
    # sums over it
    found["ssd_grad"] = grads(
        lambda *a: ssm._ssd_chunked(*a, 256),
        (dt, A, xh.float(), Bc.float(), Cc.float(), rnd(B, nh, hp, N)),
        ((Shard(0), Shard(2)), (Replicate(), Shard(0)),
         (Shard(0), Replicate()), (Shard(0), Replicate()),
         (Shard(0), Replicate()), (Shard(0), Shard(1))))

    def block_grad(cfg, plain, sharded, x):
        """The largest error, over max |want|, of the gradients of a
        whole Mamba block's input and of every weight."""
        fn = ssm.block_fn(cfg)
        w = rnd(*x.shape)
        with torch.enable_grad():
            xs = x.clone().requires_grad_()
            ps = dict(plain.blocks[0].ssm.named_parameters())
            want = torch.autograd.grad(
                (fn(cfg, plain.blocks[0].ssm, xs)[0] * w).sum(),
                [xs] + list(ps.values()))
            xd = put(x, Shard(0), Replicate()).requires_grad_()
            pd = {k: t.requires_grad_() for k, t in
                  sharded.blocks[0].ssm.named_parameters()}
            with implicit_replication():
                out = fn(cfg, sharded.blocks[0].ssm, xd)[0]
                got = torch.autograd.grad(
                    (out * put(w, Shard(0), Replicate())).sum(),
                    [xd] + [pd[k] for k in ps])
        return max(err(g, wt) / float(wt.abs().max())
                   for g, wt in zip(got, want))

    # whole Mamba blocks' backward, each rank on its own d_inner channels
    # (Mamba-1) or heads (Mamba-2: over 64 tokens, the float32 scan that
    # training takes at these lengths, not the SSD's bfloat16 chunks; its
    # conv leaves split 72 a rank against 64 x-channels, and its gated
    # norm's mean sums over the model axis)
    found["mamba1_block_grad"] = block_grad(*modules["mamba1_block"])
    cfg, plain, sharded, _ = modules["mamba2_block"]
    found["mamba2_block_grad"] = block_grad(cfg, plain, sharded,
                                            rnd(4, 64, cfg.d_model))

    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(found, f)
    dist.destroy_process_group()


def main():
    sys.modules["jax"] = None  # the port must not need it
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4,
             join=True)


if __name__ == "__main__":
    main()
