"""Run the sharded train and serving steps of one package on a 4-device mesh
and write what they computed.

    python tests/torch_shard_worker.py ref  IN OUT
    python tests/torch_shard_worker.py port IN OUT PORT

``IN`` is a pickle ``{"cases": [...], ...}`` made by the test module: each
case names an arch (its SMOKE config, changed by the ``ModelConfig.with_``
fields of its ``cut``: ``with_cut``), a mesh and what to run, and carries
its starting state, weights and inputs as numpy arrays in the reference's
layout.  ``ref`` runs the reference (``repro``) on 4 forced host devices;
``port`` runs the port (``repro_torch``) on 4 gloo ranks joined on
``tcp://127.0.0.1:PORT`` with JAX blocked, and rank 0 writes.  ``OUT``
gets a pickle {case name: result} of numpy arrays, each state leaf's
sharding spec (as a tuple) and the losses; a case that raises records
its error instead.

Case kinds: ``train`` (two steps of ``build_train_step``; the reference
also records m and v before the first step and after each, and each
step's learning rate, for the test's AdamW bound), ``serve``
(``build_prefill_step`` on a zero cache, then ``build_decode_step`` steps
over that cache; the port also records, in call order, whether each
``summed`` of the prefill met a Partial sum), ``restore`` (one step on a (4, 1) mesh, a checkpoint,
restored onto a 2-rank (2, 1) mesh, one more step) and ``resize`` (a
``Trainer`` on (4, 1) resized onto (2, 2), one more step).  In every case
the port records, per Mamba mixer call and in call order, whether the
``in_proj`` product's x output was split on d_inner over the model axis
(``ssm_by_channel``), in call order whether the gradient handed to the
embedding's row read held a Partial placement (``embed_grad_partial``),
per decode attention
call on the kv heads' split whether it ran on local shards and how many kv
heads a rank held (``decode_kv_local``; torch 2.11 rejects the DTensor
einsum there), per LM head call on more than one row whether its logits
came out split on their rows over the model axis (``head_rows``), per
q reaching the chunked attention its placement on the model axis as it
arrived ("R", "S(d)" or "P") and whether ``split_q_heads`` split it on
its heads (``q_heads``), and
per MoE layer call, in call order, each rank's local
expert block (E, C, d) (``expert_blocks``, one list a rank) and the pairs
the call's capacity dropped in each half of its tokens (``moe_dropped``).
"""
import dataclasses
import contextlib
import os
import pickle
import sys
import traceback
import time
import types

import numpy as np

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def with_cut(cfg, cut):
    """``cfg.with_(**cut)``; a ``moe`` entry of ``cut`` is a dict of
    ``MoEConfig`` fields that change the config's own (either package's
    config: the cut crosses between them as plain values)."""
    cut = dict(cut or {})
    if "moe" in cut:
        cut["moe"] = dataclasses.replace(cfg.moe, **cut["moe"])
    return cfg.with_(**cut)


def ref_state_tree(d):
    """{"step", "params", "m", "v"} -> an object with those attributes."""
    return types.SimpleNamespace(**d)


# -- the reference ------------------------------------------------------------


def run_ref(cases, tmp):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from repro.ckpt import checkpoint as ckpt
    from repro.configs import get_config
    from repro.launch import steps
    from repro.launch.mesh import make_local_mesh
    from repro.models.config import ShapeConfig
    from repro.optim.adamw import OptConfig, TrainState
    from repro.runtime.trainer import Trainer, TrainerConfig

    def cfg_of(case):
        return with_cut(get_config(case["arch"], smoke=True).with_(
            dtype=case["dtype"]), case.get("cut"))

    def state_of(d, shardings):
        st = TrainState(np.asarray(d["step"], np.int32), d["params"], d["m"],
                        d["v"])
        return jax.device_put(st, shardings)

    def numpy_state(st):
        return {"step": np.asarray(st.step), **{
            f: jax.tree.map(np.asarray, getattr(st, f))
            for f in ("params", "m", "v")}}

    def specs(st):
        return {f: jax.tree.map(lambda x: tuple(x.sharding.spec),
                                getattr(st, f)) for f in ("params", "m", "v")}

    def train_built(cfg, case, mesh):
        shape = ShapeConfig("s", "train", case["seq"], case["batch"])
        return steps.build_train_step(
            cfg, shape, make_local_mesh(*mesh), OptConfig(**OPT),
            n_acc=case["n_acc"], masked=True, mode=case.get("mode", "tp"),
            fsdp=case.get("fsdp"))

    out = {}
    for case in cases:
        t0 = time.perf_counter()
        try:
            cfg = cfg_of(case)
            res = {}
            if case["kind"] == "train":
                built = train_built(cfg, case, case["mesh"])
                st = state_of(case["state"], built.in_shardings[0])
                losses, lrs = [], []
                # m and v before the first step and after each: each
                # step's gradient and v-hat for the test's AdamW bound
                moments = [{f: case["state"][f] for f in ("m", "v")}]
                for b in case["batches"]:
                    st, m = built.fn(st, b)
                    losses.append(float(m["loss"]))
                    lrs.append(float(m["lr"]))
                    # copies: the next step donates the state's buffers
                    moments.append({f: jax.tree.map(np.array, getattr(st, f))
                                    for f in ("m", "v")})
                res = dict(losses=losses, state=numpy_state(st),
                           specs=specs(st), n_acc=built.meta["n_acc"],
                           moments=moments, lrs=lrs)
                # the same steps on one device: the reference's own spread
                one = train_built(cfg, dict(case, fsdp=None), (1, 1))
                st = state_of(case["state"], one.in_shardings[0])
                for b in case["batches"]:
                    st, _ = one.fn(st, b)
                res["one_device_state"] = numpy_state(st)
            elif case["kind"] == "restore":
                b4 = train_built(cfg, case, (4, 1))
                st = state_of(case["state"], b4.in_shardings[0])
                st, m0 = b4.fn(st, case["batches"][0])
                d = os.path.join(tmp, "ref_" + case["name"])
                ckpt.save(d, 1, st)
                b2 = train_built(cfg, case, (2, 1))
                st, step = ckpt.restore(d, jax.tree.map(np.asarray, st),
                                        sharding_tree=b2.in_shardings[0])
                st, m = b2.fn(st, case["batches"][1])
                res = dict(losses=[float(m0["loss"]), float(m["loss"])],
                           state=numpy_state(st), specs=specs(st),
                           restored_step=step)
            elif case["kind"] == "resize":
                b4 = train_built(cfg, case, (4, 1))
                b22 = train_built(cfg, case, (2, 2))
                st = state_of(case["state"], b4.in_shardings[0])
                tr = Trainer(TrainerConfig(ckpt_dir=os.path.join(tmp, "r")),
                             st, b4.fn, iter(()),
                             state_shardings=b4.in_shardings[0])
                tr.resize(b22.in_shardings[0])
                st, m = b22.fn(tr.state, case["batches"][0])
                res = dict(losses=[float(m["loss"])], state=numpy_state(st),
                           specs=specs(st))
            elif case["kind"] == "serve":
                mesh = make_local_mesh(*case["mesh"])
                B, S = case["batch"], case["seq"]
                pre = steps.build_prefill_step(
                    cfg, ShapeConfig("p", "prefill", S, B), mesh)
                dec = steps.build_decode_step(
                    cfg, ShapeConfig("d", "decode", S, B), mesh)
                params = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                                      case["params"], pre.abstract_args[0])
                params = jax.device_put(params, pre.in_shardings[0])
                cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     pre.abstract_args[1])
                cache = jax.device_put(cache, pre.in_shardings[1])
                inputs = {k: jnp.asarray(v).astype(pre.abstract_args[2][k].dtype)
                          for k, v in case["inputs"].items()}
                logits, cache = pre.fn(params, cache, inputs)
                res["prefill_logits"] = np.asarray(logits.astype(jnp.float32))
                res["prefill_cache"] = jax.tree.map(
                    lambda t: np.asarray(t.astype(jnp.float32)), cache)
                dl = []
                for tok, pos in zip(case["tokens"], case["positions"]):
                    logits, cache = dec.fn(params, cache, jnp.asarray(tok),
                                           jnp.int32(pos))
                    dl.append(np.asarray(logits.astype(jnp.float32)))
                res["decode_logits"] = dl
                res["decode_cache"] = jax.tree.map(
                    lambda t: np.asarray(t.astype(jnp.float32)), cache)
            out[case["name"]] = dict(res, seconds=time.perf_counter() - t0)
        except Exception:  # recorded; the test reports it
            out[case["name"]] = {"error": traceback.format_exc()}
    return out


# -- the port -----------------------------------------------------------------


def port_rank(rank, port, cases, tmp, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.carry import (params_from_reference,
                                          state_from_reference, state_to_numpy)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import OptConfig, TrainState
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)  # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)

    def cfg_of(case):
        return with_cut(get_config(case["arch"], smoke=True).with_(
            dtype=case["dtype"]), case.get("cut"))

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def numpy_state(st):
        whole = TrainState(full(st.step), *({k: full(v) for k, v in
                                             getattr(st, f).items()}
                                            for f in ("params", "m", "v")))
        return state_to_numpy(whole)

    def specs(st):
        return {f: {k: shd.spec_of(v.device_mesh, v.placements, v.ndim)
                    for k, v in getattr(st, f).items()}
                for f in ("params", "m", "v")}

    def train_built(cfg, case, mesh):
        shape = ShapeConfig("s", "train", case["seq"], case["batch"])
        return steps.build_train_step(
            cfg, shape, make_local_mesh(*mesh, device="cpu"),
            OptConfig(**OPT), n_acc=case["n_acc"], masked=True,
            mode=case.get("mode", "tp"), fsdp=case.get("fsdp"))

    def start(cfg, case, built):
        st = state_from_reference(cfg, ref_state_tree(case["state"]),
                                  device="cpu")
        return steps.shard_state(st, built.in_shardings[0])

    out = {}
    by_channel = _record_mixers()
    layouts = _record_layouts()
    moe_seen = _record_moe()
    blocks = {}
    for case in cases:
        t0 = time.perf_counter()
        by_channel.clear()
        for v in (*layouts.values(), *moe_seen.values()):
            v.clear()
        try:
            cfg = cfg_of(case)
            res = {}
            if case["kind"] == "train":
                built = train_built(cfg, case, case["mesh"])
                st = start(cfg, case, built)
                losses = []
                for b in case["batches"]:
                    st, m = built.fn(st, b)
                    losses.append(float(m["loss"]))
                res = dict(losses=losses, state=numpy_state(st),
                           specs=specs(st), n_acc=built.meta["n_acc"])
            elif case["kind"] == "restore":
                b4 = train_built(cfg, case, (4, 1))
                st = start(cfg, case, b4)
                st, m0 = b4.fn(st, case["batches"][0])
                d = os.path.join(tmp, "port_" + case["name"])
                ckpt.save(d, 1, st)
                b2 = train_built(cfg, case, (2, 1))
                if rank < 2:  # the 2-rank mesh: ranks 0 and 1
                    st, step = ckpt.restore(d, st,
                                            sharding_tree=b2.in_shardings[0])
                    st, m = b2.fn(st, case["batches"][1])
                    res = dict(losses=[float(m0["loss"]), float(m["loss"])],
                               state=numpy_state(st), specs=specs(st),
                               restored_step=step)
            elif case["kind"] == "resize":
                b4 = train_built(cfg, case, (4, 1))
                b22 = train_built(cfg, case, (2, 2))
                st = start(cfg, case, b4)
                before = numpy_state(st)
                tr = Trainer(TrainerConfig(ckpt_dir=os.path.join(tmp, "r")),
                             st, b4.fn, iter(()),
                             state_shardings=b4.in_shardings[0])
                tr.resize(b22.in_shardings[0])
                after = numpy_state(tr.state)
                res["resize_bitwise"] = all(
                    np.array_equal(a, b) for a, b in zip(
                        _leaves(before), _leaves(after)))
                res["resize_events"] = [e["kind"] for e in tr.events]
                res["resize_specs"] = specs(tr.state)
                st, m = b22.fn(tr.state, case["batches"][0])
                res.update(losses=[float(m["loss"])], state=numpy_state(st),
                           specs=specs(st))
            elif case["kind"] == "serve":
                mesh = make_local_mesh(*case["mesh"], device="cpu")
                B, S = case["batch"], case["seq"]
                pre = steps.build_prefill_step(
                    cfg, ShapeConfig("p", "prefill", S, B), mesh)
                dec = steps.build_decode_step(
                    cfg, ShapeConfig("d", "decode", S, B), mesh)
                model = params_from_reference(cfg, case["params"],
                                              device="cpu")
                steps.shard_model(model, pre.in_shardings[0])
                cache = steps.init_cache(pre)
                with _prefill_layouts() as seen:
                    logits, cache = pre.fn(model, cache, {
                        k: torch.from_numpy(v)
                        for k, v in case["inputs"].items()})
                res.update(seen)

                def host(tree):
                    # a copy: a replicated leaf's local tensor is the
                    # cache itself, which the decode steps write on
                    return _tree_numpy(shd.tree_map(
                        lambda t: full(t).to(torch.float32).clone(), tree))

                res["prefill_logits"] = full(logits).float().numpy()
                res["prefill_cache"] = host(cache)
                dl = []
                for tok, pos in zip(case["tokens"], case["positions"]):
                    logits, cache = dec.fn(model, cache,
                                           torch.from_numpy(tok), pos)
                    dl.append(full(logits).float().numpy())
                res["decode_logits"] = dl
                res["decode_cache"] = host(cache)
            out[case["name"]] = dict(res, ssm_by_channel=list(by_channel),
                                     moe_dropped=list(moe_seen["dropped"]),
                                     **{k: list(v) for k, v in
                                        layouts.items()},
                                     seconds=time.perf_counter() - t0)
        except Exception:  # recorded; the test reports it
            out[case["name"]] = {"error": f"rank {rank}: "
                                          + traceback.format_exc()}
        blocks[case["name"]] = list(moe_seen["blocks"])
    every = [None] * 4
    dist.all_gather_object(every, ({k: "error" in v for k, v in out.items()},
                                   blocks))
    if rank == 0:
        for r, (errs, _) in enumerate(every[1:], 1):
            for k, bad in errs.items():
                if bad and "error" not in out[k]:
                    out[k] = {"error": f"rank {r} failed"}
        for k, v in out.items():
            if "error" not in v:
                v["expert_blocks"] = [b[k] for _, b in every]
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


@contextlib.contextmanager
def _prefill_layouts():
    """Record, while the block is open, whether each ``summed`` call of
    the model code met a Partial placement (``summed_partial``), in call
    order."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.models import encdec, transformer

    seen = {"summed_partial": []}
    summed = transformer.summed

    def summed_rec(t, *a):
        seen["summed_partial"].append(isinstance(t, DTensor) and any(
            isinstance(p, Partial) for p in t.placements))
        return summed(t, *a)

    mods = ((transformer, "summed", summed_rec), (encdec, "summed", summed_rec))
    old = [getattr(m, n) for m, n, _ in mods]
    for m, n, f in mods:
        setattr(m, n, f)
    try:
        yield seen
    finally:
        for (m, n, _), f in zip(mods, old):
            setattr(m, n, f)


def _record_mixers() -> list:
    """From now on record, in call order, whether the x output of each
    Mamba mixer's ``in_proj`` product (``ssm._in_proj``) is a DTensor
    split on its last dimension (d_inner) over the model mesh axis; the
    list returned receives the records."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models import ssm

    seen = []
    in_proj = ssm._in_proj

    def rec(cfg, p, x, j):
        out = in_proj(cfg, p, x, j)
        xi = out[0] if cfg.ssm.version == 1 else out[1]
        names = getattr(getattr(xi, "device_mesh", None), "mesh_dim_names",
                        None) or ()
        pl = (xi.placements[names.index("model")]
              if isinstance(xi, DTensor) and "model" in names else None)
        seen.append(isinstance(pl, Shard) and pl.dim == xi.ndim - 1)
        return out

    ssm._in_proj = rec
    return seen


def _record_layouts() -> dict:
    """From now on record, in call order: whether the gradient handed to
    the embedding's row read (``common.lookup``'s rows, after ``grad_like``)
    held a Partial placement (``embed_grad_partial``), for each decode
    attention call on the kv heads (``attention._decode_kv_heads``)
    whether its operands were local shards and the kv heads of the
    rank's cache shard (``decode_kv_local``), for each LM head call
    on more than one row (``LM._head``) whether its logits came out split
    on their rows (Shard(1)) over the model axis (``head_rows``), and for
    each q of the chunked attention (``split_q_heads`` on a 5-D q) its
    placement on the model axis as it arrived and whether it left split
    on its heads (``q_heads``).  Returns the dict of lists that receive
    them."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.models import attention, common, transformer

    seen = {"embed_grad_partial": [], "decode_kv_local": [],
            "head_rows": [], "q_heads": []}
    like, kv_heads = common.grad_like, attention._decode_kv_heads
    head, split = transformer.LM._head, attention.split_q_heads

    def split_rec(t, dim, groups):
        out = split(t, dim, groups)
        if out[0].ndim == 5:  # the chunked attention's q, not the decode's
            seen["q_heads"].append((_model_placement(t), out[1]))
        return out

    def head_rec(self, x):
        out = head(self, x)
        if x.shape[1] > 1:
            names = getattr(getattr(out, "device_mesh", None),
                            "mesh_dim_names", None) or ()
            pl = (out.placements[names.index("model")]
                  if isinstance(out, DTensor) and "model" in names else None)
            seen["head_rows"].append(isinstance(pl, Shard) and pl.dim == 1)
        return out

    def like_rec(t):
        if isinstance(t, DTensor) and t.requires_grad:
            t.register_hook(lambda g: seen["embed_grad_partial"].append(
                any(isinstance(p, Partial) for p in g.placements)))
        return like(t)

    def kv_rec(qh, k, v, **kw):
        seen["decode_kv_local"].append(
            (not any(isinstance(a, DTensor) for a in (qh, k, v)),
             int(k.shape[2])))
        return kv_heads(qh, k, v, **kw)

    common.grad_like, attention._decode_kv_heads = like_rec, kv_rec
    transformer.LM._head, attention.split_q_heads = head_rec, split_rec
    return seen


def _model_placement(t) -> str:
    """DTensor ``t``'s placement on the ``model`` mesh axis: "R", "S(d)"
    or "P"; "-" for a plain tensor or a mesh without that axis."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    names = getattr(getattr(t, "device_mesh", None), "mesh_dim_names",
                    None) or ()
    if not isinstance(t, DTensor) or "model" not in names:
        return "-"
    p = t.placements[names.index("model")]
    if isinstance(p, Shard):
        return f"S({p.dim})"
    return "P" if isinstance(p, Partial) else "R"


def _record_moe() -> dict:
    """From now on record, per MoE layer call and in call order,
    the shape of the rank's expert block (``moe._experts``' capacity
    buffers, (E, C, d), as a tuple: ``blocks``) and the pairs the call's
    capacity dropped among the first and the second half of its tokens
    (``moe.slots``: ``dropped``).  Returns the dict of lists that receive
    them."""
    from repro_torch.models import moe

    seen = {"blocks": [], "dropped": []}
    experts, slots = moe._experts, moe.slots

    def experts_rec(eb, *w):
        seen["blocks"].append(tuple(eb.shape))
        return experts(eb, *w)

    def slots_rec(cfg, gate_idx):
        out = slots(cfg, gate_idx)
        drop = ~out[1].view(2, -1) if gate_idx.shape[0] % 2 == 0 else None
        seen["dropped"].append(None if drop is None else
                               [int(h.sum()) for h in drop])
        return out

    moe._experts, moe.slots = experts_rec, slots_rec
    return seen


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def main():
    mode, inp, outp = sys.argv[1:4]
    with open(inp, "rb") as f:
        spec = pickle.load(f)
    tmp = os.path.dirname(outp)
    if mode == "ref":
        out = run_ref(spec["cases"], tmp)
        with open(outp, "wb") as f:
            pickle.dump(out, f)
        return
    sys.modules["jax"] = None  # the port must not need it
    import torch.multiprocessing as mp
    mp.spawn(port_rank, args=(int(sys.argv[4]), spec["cases"], tmp, outp),
             nprocs=4, join=True)


if __name__ == "__main__":
    main()
