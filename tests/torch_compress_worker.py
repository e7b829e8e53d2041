"""Run the port's ``compress_with_noise`` on gloo ranks and save each rank's
result.

    python tests/torch_compress_worker.py PORT WORLD INPUTS.npz OUTDIR

Rank r joins a gloo group of WORLD ranks on ``tcp://127.0.0.1:PORT``,
reads its gradients, error state and noise (``g/r/<leaf>``, ``e/r/<leaf>``,
``n/r/<leaf>``) from INPUTS.npz, reduces over the world, and writes
``OUTDIR/rank<r>.npz`` (``out/<leaf>``, ``err/<leaf>``).  JAX is blocked in
every rank: this side of the parity test is the port alone.
"""
import sys

sys.modules["jax"] = None  # the port must not need it

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def rank_main(rank, port, world, inputs, outdir):
    from repro_torch.optim.compress import compress_with_noise

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    data = np.load(inputs)

    def part(kind):
        pre = f"{kind}/{rank}/"
        return {k[len(pre):]: torch.from_numpy(data[k])
                for k in sorted(data.files) if k.startswith(pre)}

    out, err = compress_with_noise(part("g"), part("e"), part("n"),
                                   group=dist.group.WORLD)
    np.savez(f"{outdir}/rank{rank}.npz",
             **{f"out/{k}": v.numpy() for k, v in out.items()},
             **{f"err/{k}": v.numpy() for k, v in err.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    port, world = int(sys.argv[1]), int(sys.argv[2])
    mp.spawn(rank_main, args=(port, world, sys.argv[3], sys.argv[4]),
             nprocs=world, join=True)
    print("DONE", flush=True)
