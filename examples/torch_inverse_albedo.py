"""Inverse rendering on the PyTorch port: recover the white walls' albedo
and the light's radiance with Adam.

Mirrors the reference's downstream optimization workflow
(README.md:113-115 points users at torch Adam): ``torch.optim.Adam`` on
the gradients of ``renderD`` (reverse mode, ``loss.backward()``), a fresh
sample set each iteration.

Run: python examples/torch_inverse_albedo.py         (on the card)
     main(device="cpu", size=8, iters=2) runs it small on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_scenes import make_cbox, pt  # noqa: E402


def main(device="cuda", size=64, spp=8, iters=100):
    sc = make_cbox(width=size, height=size, spp=spp, device=device)
    sc.configure()
    integrator = pt.PathTracer(max_depth=2)
    bsdf = sc.param_map["BSDF[id=white]"]
    em = sc.emitters[0]
    true_alb = bsdf.reflectance.data.clone()
    true_rad = em.radiance.clone()
    target = integrator.renderC(sc, 0, seed=3)

    def loss_fn(alb, log_rad, seed):
        bsdf.reflectance.data = alb
        em.radiance = torch.exp(log_rad)
        img = integrator.renderD(sc, 0, seed=seed)
        return torch.mean(torch.square(img - target))

    alb = (true_alb * 0.3).requires_grad_()
    log_rad = torch.log(true_rad * 3.0).requires_grad_()
    opt = torch.optim.Adam([alb, log_rad], lr=5e-2)
    losses = []
    try:
        for it in range(iters):
            opt.zero_grad()
            loss = loss_fn(alb, log_rad, it)
            loss.backward()
            opt.step()
            with torch.no_grad():
                alb.clamp_(0.0, 1.0)
            losses.append(loss.item())
            if it % 10 == 0:
                print(f"iter {it:3d}  loss {losses[-1]:.3e}")
    finally:
        bsdf.reflectance.data = true_alb
        em.radiance = true_rad
    print("recovered albedo:", alb.detach().reshape(-1).tolist(),
          "(true", true_alb.reshape(-1).tolist(), ")")
    print("recovered radiance:", torch.exp(log_rad).detach().tolist(),
          "(true", true_rad.tolist(), ")")
    return alb.detach(), torch.exp(log_rad).detach(), losses


if __name__ == "__main__":
    main()
