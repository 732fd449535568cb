"""Batch/crop rendering on the PyTorch port (reference tutorial
batch_render.ipynb): render a pixel subset with the same seed and verify
it is bitwise-consistent with the full frame, the contract that also makes
the pixel-sharded render exact.

Run: python examples/torch_batch_render.py            (on the card)
     main(device="cpu", size=16) renders it small on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_scenes import make_cbox, pt  # noqa: E402


def main(device="cuda", size=128, spp=8):
    sc = make_cbox(width=size, height=size, spp=spp, device=device)
    sc.configure()
    integrator = pt.PathTracer(max_depth=2)

    full = integrator.renderC(sc, 0, seed=5)

    # a quarter-size crop at (3/8, 3/8) of the frame: 32x32 at (48, 48)
    lo, n = size * 3 // 8, size // 4
    ys, xs = torch.meshgrid(torch.arange(lo, lo + n),
                            torch.arange(lo, lo + n), indexing="ij")
    crop_ids = (ys * size + xs).reshape(-1).to(sc.device)
    crop = integrator.renderC(sc, 0, seed=5, batch_pix=crop_ids)

    exact = torch.equal(crop, full[crop_ids])
    print("crop == full-frame slice (bitwise):", exact)
    assert exact
    return exact


if __name__ == "__main__":
    main()
