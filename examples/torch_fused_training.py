"""Production inverse-rendering loop with the fused forward+adjoint step,
on the PyTorch port.

The fused step (``Integrator.loss_and_grad``, integrator/fused.py)
computes loss, parameter gradients and the rendered image in ONE forward
and ONE adjoint sweep with zero recompute, the cost structure of the
reference's Dr.Jit tape backward (reference README.md:102-104), for any
pixel-local loss. On the card the box's interior runs through the K2
stash, K3 and K4 kernels. Over several ranks of ``torch.distributed`` the
same step shards pixel rows and edge-sample lanes
(``parallel.make_fused_train_step``; examples/torch_multihost_training.py).

Here: recover the light's radiance and an x-shift of the red wall from a
wrong start, with per-parameter Adam learning rates.

Run: python examples/torch_fused_training.py          (on the card)
     main(device="cpu", size=8, iters=2, check=False) runs it small.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_scenes import make_cbox, pt  # noqa: E402


def main(device="cuda", size=32, iters=40, check=True):
    w = size
    sc = make_cbox(width=w, height=w, spp=4, sppe=2, sppse=2, device=device)
    sc.configure()
    integ = pt.PathTracer(max_depth=1)
    em = sc.emitters[0]
    box = sc.meshes[-1]
    base_r = em.radiance.clone()
    base_v = box.vertex_positions_raw.clone()

    # target: the unperturbed scene; start from wrong radiance + shifted box
    target = integ.renderC(sc, 0, seed=11)
    params = {
        "radiance": (base_r * 1.8).requires_grad_(),
        "dx": torch.tensor(40.0, requires_grad=True),  # cbox units
    }
    x_axis = torch.tensor([1.0, 0.0, 0.0])

    def apply_params(p):
        em.radiance = p["radiance"]
        box.vertex_positions_raw = base_v + x_axis * p["dx"]

    def pixel_loss(rows, pix_ids):
        return torch.sum(torch.square(rows - target[pix_ids]), dim=-1)

    # per-parameter Adam scales: geometry moves in cbox units (~0-550),
    # radiance in radiance units; one global lr cannot serve both
    opt = torch.optim.Adam([{"params": [params["dx"]], "lr": 8.0},
                            {"params": [params["radiance"]], "lr": 0.4}])
    for it in range(iters):
        # fresh sample set per step
        loss, grads, _ = integ.loss_and_grad(sc, params, apply_params,
                                             pixel_loss, seed=11 + it)
        for k, v in params.items():
            v.grad = grads[k].to(v.device)
        opt.step()
        if it % 5 == 0 or it == iters - 1:
            err = (params["radiance"] - base_r).abs().max().item()
            print(f"iter {it:3d}  loss {float(loss):10.4f}  "
                  f"dx {params['dx'].item():7.3f}  radiance err {err:.3f}")
    apply_params({k: v.detach() for k, v in params.items()})
    dx = params["dx"].item()
    rad_err = (params["radiance"] - base_r).abs().max().item()
    if check:
        assert abs(dx) < 0.5 * 40.0
        assert rad_err < 0.5 * float((base_r * 0.8).abs().max())
        print("recovered box position and radiance")
    return dx, rad_err


if __name__ == "__main__":
    main()
