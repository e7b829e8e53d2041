"""Run the port's decentralized engine on 4 gloo ranks and print its results.

    python tests/torch_dist_worker.py PORT

Ranks 0-3 join one gloo group on ``tcp://127.0.0.1:PORT``; every case runs
on a 2-rank group (ranks 0, 1) and on the 4-rank world.  Rank 0 prints one
line ``RESULT <json>``: per (D, case) the mapping and the ``DistStats``.
JAX is blocked in every rank: this side of the parity test is the port
alone.
"""
import json
import sys

sys.modules["jax"] = None  # the port must not need it

import dataclasses  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def cases(T):
    yield "paper", *T.paper_example()
    for seed in range(6):
        rg = T.waxman(26, seed=seed)
        yield f"waxman26_{seed}", rg, T.random_dataflow(rg, 6, seed=seed + 11)


def record(m, st):
    out = {"stats": dataclasses.asdict(st)}
    if m is not None:
        out.update(assign=list(m.assign), route=list(m.route), cost=m.cost)
    return out


def rank_main(rank, port):
    import repro_torch.core as T
    from repro_torch.core.distributed import leastcost_shard_map

    torch.set_num_threads(1)  # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    results = {}
    for D, group in groups.items():
        if rank >= D:
            continue
        for name, rg, df in cases(T):
            m, st = leastcost_shard_map(rg, df, group=group, device="cpu")
            results[f"{D}/{name}"] = record(m, st)
    every = [None] * 4
    dist.all_gather_object(every, results)
    if rank == 0:
        for r, theirs in enumerate(every):
            for key, val in theirs.items():
                assert results[key] == val, f"rank {r} disagrees on {key}"
        print("RESULT " + json.dumps(results), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(int(sys.argv[1]),), nprocs=4, join=True)
