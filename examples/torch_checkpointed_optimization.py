"""Checkpoint / resume for inverse-rendering optimization, on the PyTorch
port.

The reference has no framework-level checkpointing (SURVEY.md §5): its
persistence is Mesh.dump() + EXR writes, with determinism from explicit
seeds. Here the same determinism contract plus ``torch.save`` gives
resume-exactly semantics for long optimizations: the parameters, the
optimizer state and the iteration counter round-trip through a checkpoint
file each iteration, and a run stopped and resumed from its checkpoint
ends where the straight run ends.

The check: on the CPU the resumed parameters equal the straight run's bit
for bit. On the card they are held to the JAX example's 1e-6: the card
sums the gradient's lanes with float atomics, whose order, and so whose
last bits, vary from run to run.

Run: python examples/torch_checkpointed_optimization.py   (on the card)
     main(device="cpu", size=8, iters=3, resume_at=2) runs it small.
"""

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from torch_scenes import make_cbox, pt  # noqa: E402


def main(device="cuda", size=32, spp=4, iters=20, resume_at=10):
    ckpt_dir = tempfile.mkdtemp(prefix="psdr_ckpt_")
    sc = make_cbox(width=size, height=size, spp=spp, device=device)
    sc.configure()
    integ = pt.PathTracer(1)
    bsdf = sc.param_map["BSDF[id=white]"]
    true_alb = bsdf.reflectance.data.clone()
    target = integ.renderC(sc, 0, seed=3)

    def loss_fn(alb, seed):
        bsdf.reflectance.data = alb
        img = integ.renderD(sc, 0, seed=seed)
        return torch.mean(torch.square(img - target))

    def ckpt(it):
        return os.path.join(ckpt_dir, f"{it}.pt")

    def run(alb, opt_state, start_it, n_iters):
        alb = alb.detach().clone().requires_grad_()
        opt = torch.optim.Adam([alb], lr=5e-2)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        loss = None
        for it in range(start_it, n_iters):
            opt.zero_grad()
            loss = loss_fn(alb, it)
            loss.backward()
            opt.step()
            torch.save({"params": alb.detach(), "opt_state": opt.state_dict(),
                        "it": it}, ckpt(it))
        return alb.detach(), loss.item()

    try:
        # straight run of `iters` iterations
        p_full, loss_full = run(true_alb * 0.3, None, 0, iters)
        # interrupted run: `resume_at` iterations, then restore and finish
        run(true_alb * 0.3, None, 0, resume_at)
        restored = torch.load(ckpt(resume_at - 1), weights_only=True)
        p_resumed, loss_resumed = run(restored["params"],
                                      restored["opt_state"],
                                      restored["it"] + 1, iters)
    finally:
        bsdf.reflectance.data = true_alb
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    bitwise = torch.equal(p_full, p_resumed)
    close = bool(torch.allclose(p_full, p_resumed, rtol=0.0, atol=1e-6))
    print(f"final loss: straight {loss_full:.3e}  resumed {loss_resumed:.3e}")
    print("resume == straight run:", close, " bitwise:", bitwise)
    assert bitwise if sc.device.type == "cpu" else close
    return bitwise, close


if __name__ == "__main__":
    main()
