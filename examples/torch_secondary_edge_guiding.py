"""Secondary-edge guiding on the PyTorch port (reference tutorial
secondary_edge_guiding.ipynb): build the 3D guiding table before renderD
so boundary samples concentrate where the integrand has mass, then take
the forward-mode derivative of the mean pixel along the tall block's
x-translation for four seeds.

Run: python examples/torch_secondary_edge_guiding.py   (on the card)
     main(device="cpu", size=16, reso=(4, 2, 2, 2)) runs it small.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_scenes import make_cbox, pt  # noqa: E402


def main(device="cuda", size=64, spp=4, reso=(16, 4, 4, 8), seeds=4):
    sc = make_cbox(width=size, height=size, spp=spp, sppe=0, sppse=spp,
                   device=device)
    sc.configure()
    integrator = pt.PathTracer(max_depth=1)

    # reference call shape: preprocess_secondary_edges(sc, 0, [x,y,z,spp], n)
    t0 = time.time()
    integrator.preprocess_secondary_edges(sc, 0, list(reso), nrounds=1)
    print(f"guiding table built in {time.time() - t0:.2f}s")

    # the tall block (the JAX example takes "Mesh[7]", the red wall)
    mesh = sc.param_map["Mesh[2]"]
    base = mesh.to_world_raw
    e03 = torch.zeros(4, 4)
    e03[0, 3] = 1.0

    def render(tx, seed):
        mesh.to_world_raw = base + e03 * tx
        return integrator.renderD(sc, 0, seed=seed)

    grads = []
    try:
        for seed in range(seeds):
            _, d = torch.func.jvp(lambda t: torch.mean(render(t, seed)),
                                  (torch.zeros(()),), (torch.ones(()),))
            grads.append(float(d))
    finally:
        mesh.to_world_raw = base
    print("guided d(mean)/dtx per seed:", ["%.3e" % g for g in grads])
    return grads


if __name__ == "__main__":
    main()
