"""Faults planted under a renderer package's timed path, for the check's
own tests and for reading the check's upper limits (``calibrate.py``):

- ``unchanged``: the training step returns the parameters' state
  unchanged (``loss_and_grad`` gives zero gradients, so Adam moves
  nothing);
- ``half_batch``: half of each pixel's interior samples left out, the mean
  taken over the rest;
- ``altered``: every interior row altered where it is produced (scaled by
  ``1 + ALTER``);
- ``doubled``: one leaf's gradient counted twice (the first parameter's,
  the light's translation in the box), as a doubled adjoint would; under
  Adam's first steps it moves the parameters as the right one does.

A one-card cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

ALTER = 1e-2
TRAIN_FAULTS = ("unchanged", "half_batch", "altered", "doubled")
RENDER_FAULTS = ("half_batch", "altered")


@contextlib.contextmanager
def planted(pkg, fault: str):
    """Plant ``fault`` in ``pkg`` (the port or the reference) while the
    block runs."""
    name = pkg.__name__
    base = importlib.import_module(f"{name}.integrator.base")
    fused = importlib.import_module(f"{name}.integrator.fused")
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if fault in ("unchanged", "doubled"):
        orig = fused.loss_and_grad

        def loss_and_grad(*args, **kwargs):
            loss, grads, image = orig(*args, **kwargs)
            if fault == "unchanged":
                grads = {k: torch.zeros_like(v) for k, v in grads.items()}
            else:
                first = next(iter(grads))
                grads = {**grads, first: 2 * grads[first]}
            return loss, grads, image

        patch(fused, "loss_and_grad", loss_and_grad)
    elif fault in ("half_batch", "altered"):
        orig_avg = base.interior_average

        def interior_average(value, m, spp):
            if fault == "altered":
                return orig_avg(value, m, spp) * (1.0 + ALTER)
            if spp < 2:
                return orig_avg(value, m, spp)
            half = spp // 2
            kept = value.reshape(m, spp, *value.shape[1:])[:, :half]
            return orig_avg(kept.reshape(m * half, *value.shape[1:]), m, half)

        patch(base, "interior_average", interior_average)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
