"""AOV extraction on the PyTorch port (reference tutorial
different_integrator.ipynb): depth / normals / uv / silhouette /
segmentation / position images of the Cornell box.

Run: python examples/torch_field_aovs.py [outdir]   (on the card)
     main(outdir, device="cpu", size=16) renders them small on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_scenes import make_cbox, pt  # noqa: E402
from psdr_jit_tpu_torch.utils.image import write_ppm  # noqa: E402

FIELDS = ("depth", "geoNormal", "shNormal", "uv", "silhouette",
          "segmentation", "position")


def main(outdir="out", device="cuda", size=128, spp=4):
    os.makedirs(outdir, exist_ok=True)
    sc = make_cbox(width=size, height=size, spp=spp, device=device)
    sc.configure()
    ranges = {}
    for field in FIELDS:
        img = pt.FieldExtractionIntegrator(field).renderC(sc, 0)
        img = img.reshape(size, size, 3).cpu().numpy()
        lo, hi = img.min(), img.max()
        vis = (img - lo) / (hi - lo + 1e-9)
        write_ppm(os.path.join(outdir, f"aov_{field}.ppm"), vis, gamma=1.0)
        print(f"{field:12s} range [{lo:.3g}, {hi:.3g}]")
        ranges[field] = (float(lo), float(hi))
    return ranges


if __name__ == "__main__":
    main(*sys.argv[1:])
