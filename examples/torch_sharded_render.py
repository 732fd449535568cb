"""Multi-process rendering on the PyTorch port: shard the pixel axis over
the ranks of a ``torch.distributed`` group (``parallel.render_sharded``).

The launcher starts ``world`` rank processes (gloo, at a free local port;
on one card the ranks share it, across cards NCCL takes their place).
Each rank renders its contiguous pixel block with the global sample index
and the blocks are summed into the full frame on every rank; rank 0 holds
it against the unsharded ``renderC``: bitwise equal, since any partition
of the pixels draws the full frame's samples.

Run: python examples/torch_sharded_render.py          (on the card)
     main(device="cpu", size=16) runs it small on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch_scenes import (join_group, launch_ranks, make_cbox,  # noqa: E402
                          print_launches, pt, rank_args)


def run_rank(rank, world, port, device, size, spp):
    from psdr_jit_tpu_torch.parallel import make_device_mesh, render_sharded

    join_group(rank, world, port)
    try:
        sc = make_cbox(width=size, height=size, spp=spp, device=device)
        sc.configure()
        integrator = pt.PathTracer(max_depth=2)
        mesh = make_device_mesh(device)
        sharded = render_sharded(integrator, sc, mesh, seed=2)
        if rank == 0:
            print("ranks:", mesh.size, "device:", mesh.device)
            single = integrator.renderC(sc, 0, seed=2)
            exact = torch.equal(sharded, single)
            print("sharded == single-process (bitwise):", exact)
            assert exact
        print_launches(rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(device="cuda", size=128, spp=8, world=2, timeout=600.0,
         stdout=None):
    """Launch ``world`` ranks (their output to ``stdout``, this process's
    when None); True where each passed its check."""
    return launch_ranks(os.path.abspath(__file__), world,
                        (device, size, spp), timeout, stdout)


if __name__ == "__main__":
    ranked = rank_args()
    if ranked is None:
        sys.exit(0 if main() else 1)
    rank, world, port, (device, size, spp) = ranked
    run_rank(rank, world, port, device, int(size), int(spp))
