"""One rank of ``tests/test_torch_parallel.py``'s sharded runs: ``python
torch_parallel_worker.py RANK WORLD PORT SCENE_NPZ OUT``. Joins a gloo group
on the CPU at ``tcp://127.0.0.1:PORT``, runs the port's sharded render,
training step and ``train_step_example`` on the scene of ``SCENE_NPZ``, and
saves what it got to ``OUT`` (``torch.save``). Imports no JAX."""

import datetime
import os
import sys

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import psdr_jit_tpu_torch as pt  # noqa: E402
from psdr_jit_tpu_torch import parallel  # noqa: E402
from chip_smoke import train_setup  # noqa: E402

DEPTH, SEED, GUIDE = 1, 3, (4, 4, 4, 2)


def tx_setter(scene):
    """``(tx0, set)``: the light's x translation, as ``train_setup``'s."""
    params, apply, _ = train_setup(scene)

    def put(v):
        apply({**params, "tx": v})
    return params["tx"], put


def main(rank, world, port, scene_npz, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = parallel.make_device_mesh("cpu")
    arrays = dict(np.load(scene_npz))
    sc = pt.Scene.from_arrays(arrays, device="cpu")
    sc.configure()
    integ = pt.PathTracer(DEPTH)
    res = {"rank": mesh.rank, "size": mesh.size}

    res["frame_C"] = parallel.render_sharded(integ, sc, mesh, 0, SEED, "C")
    tx0, put = tx_setter(sc)
    with fwAD.dual_level():
        put(fwAD.make_dual(tx0, torch.ones(())))
        primal, tangent = fwAD.unpack_dual(parallel.render_sharded(
            integ, sc, mesh, 0, SEED, "D"))
        res["frame_D"], res["tangent_D"] = primal.clone(), tangent.clone()
    put(tx0)

    params, apply, loss_fn = train_setup(sc, seed=0)
    step = parallel.make_fused_train_step(sc, integ, mesh, apply, loss_fn)
    res["step"] = step(params, SEED)

    guided = pt.PathTracer(DEPTH)
    guided.preprocess_secondary_edges(sc, 0, GUIDE, 1)
    res["table_own"] = guided.warpper[0]
    step_g = parallel.make_fused_train_step(sc, guided, mesh, apply, loss_fn)
    res["step_guided"] = step_g(params, SEED)
    res["table"] = guided.warpper[0]

    target = integ.renderC(sc, 0, seed=9) * 0.8
    res["example"] = parallel.train_step_example(
        sc, integ, mesh, lambda: {"tx": tx0}, lambda p: put(p["tx"]), target,
        seed=9)
    torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
