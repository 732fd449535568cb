"""Forward-mode gradient image on the Cornell box, on the PyTorch port.

Mirrors the reference tutorial ``tutorials/Forward_AD.ipynb``: render the
cbox, then compute the forward-mode derivative image with respect to an
x-translation of the tall block (``torch.func.jvp`` of ``renderD``): the
sum of the interior, primary-edge and secondary-edge terms
(spp/sppe/sppse = 32).

Run: python examples/torch_forward_ad.py [outdir]   (on the card)
     main(outdir, device="cpu", size=16, spp=2) runs it small on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_scenes import make_cbox, pt  # noqa: E402
from psdr_jit_tpu_torch.utils.image import write_image, write_ppm  # noqa


def main(outdir="out", device="cuda", size=256, spp=32):
    os.makedirs(outdir, exist_ok=True)
    sc = make_cbox(width=size, height=size, spp=spp, sppe=spp, sppse=spp,
                   device=device)
    sc.configure()
    integrator = pt.PathTracer(max_depth=3)

    img = integrator.renderC(sc, 0, seed=0).reshape(size, size, 3)
    write_ppm(os.path.join(outdir, "cbox.ppm"), img.cpu().numpy())

    # the tall block (the JAX example takes "Mesh[7]", the red wall)
    mesh = sc.param_map["Mesh[2]"]
    base = mesh.to_world_raw
    e03 = torch.zeros(4, 4)
    e03[0, 3] = 1.0

    def render(tx):
        mesh.to_world_raw = base + e03 * tx
        return integrator.renderD(sc, 0, seed=0)

    try:
        _, dimg = torch.func.jvp(render, (torch.zeros(()),),
                                 (torch.ones(()),))
    finally:
        mesh.to_world_raw = base
    dimg = dimg.reshape(size, size, 3).cpu().numpy()
    write_image(os.path.join(outdir, "cbox_grad.npy"), dimg)
    # signed-gradient preview: red = positive, blue = negative
    scale = np.quantile(np.abs(dimg), 0.995) + 1e-9
    vis = np.stack([np.maximum(dimg[..., 0], 0),
                    np.zeros_like(dimg[..., 0]),
                    np.maximum(-dimg[..., 0], 0)], -1) / scale
    write_ppm(os.path.join(outdir, "cbox_grad.ppm"), vis)
    print("wrote", outdir + "/cbox.ppm and cbox_grad.{npy,ppm}")
    print("grad image abs-mean:", float(np.abs(dimg).mean()))
    return dimg


if __name__ == "__main__":
    main(*sys.argv[1:])
