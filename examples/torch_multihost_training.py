"""Multi-process inverse rendering with ``torch.distributed`` (2 ranks),
on the PyTorch port.

The reference scales by adding GPUs behind drjit's single-process CUDA
stream; here every rank runs THIS SAME script, ``init_process_group``
joins them into one group, and the sharded training step
(``parallel.make_fused_train_step``) partitions pixel rows and
edge-sample lanes per rank and sums the loss and the parameter gradients
across the ranks. The global-lane RNG contract (integrator/base.py) makes
the sharded estimator equal to the single-process one up to the order of
its float sums: scaling changes wall-clock, not the numbers.

On several hosts each rank gets the group's address, the world size and
its rank (NCCL across cards). Without them, the launcher starts both
ranks on this machine, gloo at a free local port (on one card they share
it), and each recovers the light's radiance with Adam.

Run: python examples/torch_multihost_training.py      (on the card)
     main(device="cpu", size=8, iters=2, check=False) runs it small.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch_scenes import (join_group, launch_ranks, make_cbox,  # noqa: E402
                          print_launches, pt, rank_args)

N_PROC = 2


def run_rank(rank, world, port, device, size, iters, check):
    from psdr_jit_tpu_torch.parallel import (make_device_mesh,
                                             make_fused_train_step)

    join_group(rank, world, port)
    log = print if rank == 0 else (lambda *a, **k: None)
    try:
        mesh = make_device_mesh(device)
        log(f"processes: {mesh.size}, device: {mesh.device}")
        w = size
        sc = make_cbox(width=w, height=w, spp=4, sppe=2, sppse=2,
                       device=device)
        sc.configure()
        integ = pt.PathTracer(max_depth=1)
        em = sc.emitters[0]
        base_r = em.radiance.clone()
        target = integ.renderC(sc, 0, seed=11)
        params = {"radiance": (base_r * 1.6).requires_grad_()}

        def apply_params(p):
            em.radiance = p["radiance"]

        def pixel_loss(rows, pix_ids):
            return torch.sum(torch.square(rows - target[pix_ids]), dim=-1)

        step = make_fused_train_step(sc, integ, mesh, apply_params,
                                     pixel_loss)
        opt = torch.optim.Adam([params["radiance"]], lr=0.4)
        for it in range(iters):
            loss, grads, _ = step(params, 11 + it)
            params["radiance"].grad = grads["radiance"].to(
                params["radiance"].device)
            opt.step()
            if it % 5 == 0 or it == iters - 1:
                err = (params["radiance"] - base_r).abs().max().item()
                log(f"iter {it:3d}  loss {float(loss):10.4f}  "
                    f"radiance err {err:.3f}")
        err = (params["radiance"] - base_r).abs().max().item()
        if check:
            assert err < 0.5 * float((base_r * 0.6).abs().max()), err
            log(f"recovered emitter radiance across {mesh.size} ranks")
        print_launches(rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(device="cuda", size=32, iters=25, check=True, timeout=600.0,
         stdout=None):
    """Launch the two ranks (their output to ``stdout``, this process's
    when None); True where both ran (and passed the check)."""
    return launch_ranks(os.path.abspath(__file__), N_PROC,
                        (device, size, iters, int(check)), timeout, stdout)


if __name__ == "__main__":
    ranked = rank_args()
    if ranked is None:
        sys.exit(0 if main() else 1)
    rank, world, port, (device, size, iters, check) = ranked
    run_rank(rank, world, port, device, int(size), int(iters),
             bool(int(check)))
