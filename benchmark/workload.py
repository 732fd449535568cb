"""The one generator of the benchmark's traffic: a mix
(``traffic/<mix>.json``) names the entry one iteration drives; this
module drives it, on the port or on the reference package alike.

Every cell is a closed loop of one client: an iteration starts when the
last one has been read. Iteration ``i`` renders with the sampler seed
``seed + i`` (as a u32); the target image and the parameters' start come
from ``seed`` (``scenes.draw_offsets``), the target rendered with the
sampler seed ``seed - 1``.

Entries:

- ``loss_and_grad``: ``PathTracer.loss_and_grad`` (an L2 loss against the
  target) and ``Adam.step`` over the configuration's parameters, read by
  the loss. The first ``checked_steps`` iterations are the set-up's warm
  steps; their losses, the first step's image, the first gradient (from
  Adam's first moment after one step) and the parameters' change after
  them are what the check compares.
- ``renderD_forward``: forward-mode ``renderD`` along one parameter
  (``tangent``, a direction of ones), read by the tangent's sum; the
  check compares sampled iterations' primal and tangent images.
- ``renderC``: one frame, read by the image's sum; the check compares
  sampled iterations' images.

``round_to`` (a torch dtype) rounds the scene's float inputs and every
output the loop reads through that type: the control of the check, the
reference computed in a lower precision.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.autograd.forward_ad as fwAD

from scenes import (SEED_MASK, Parameters, build_scene, draw_offsets,
                    round_floats, scene_arrays)

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
ADAM_BETAS = (0.9, 0.999)


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _round(x, dtype):
    return x if dtype is None else x.to(dtype).to(x.dtype)


class Loop:
    """The scene, its parameters at their start and the integrator."""

    def __init__(self, pkg, config: dict, mix: dict, seed: int, device,
                 size=None, spp=None, round_to=None):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.round_to = round_to
        arrays = scene_arrays(config, size, spp)
        if round_to is not None:
            arrays = round_floats(arrays, round_to)
        self.n_pix = int(arrays["opts"][0] * arrays["opts"][1])
        self.counts = tuple(int(c) for c in arrays["opts"][2:])
        self.scene = build_scene(pkg, arrays, device)
        self.params = Parameters(self.scene, config)
        self.integrator = pkg.PathTracer(config["max_depth"])
        self.start, self.target_offsets = draw_offsets(config, arrays, seed)
        self.values = self.params.tensors(self.start)
        self.params.apply(self.values)
        self.scene.configure()

    def sampler_seed(self, i: int) -> int:
        return (self.seed + i) & SEED_MASK

    def warmup_iterations(self) -> int:
        return int(self.mix.get("warmup", 0))


class TrainLoop(Loop):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.params.apply(self.params.tensors(self.target_offsets))
        self.scene.configure()
        target = self.integrator.renderC(self.scene, 0,
                                         seed=(self.seed - 1) & SEED_MASK)
        self.target = _round(target, self.round_to)
        self.params.apply(self.values)
        self.scene.configure()
        self.opt = torch.optim.Adam(
            [{"params": [self.values[p["name"]]], "lr": p["lr"]}
             for p in self.config["params"]], betas=ADAM_BETAS)
        self.checked = int(self.mix["checked_steps"])
        self.record = {"loss": [], "start": {k: v.detach().cpu().clone()
                                             for k, v in self.values.items()}}

    def warmup_iterations(self) -> int:
        return self.checked

    def pixel_loss(self, rows, pix):
        return ((rows - self.target[pix]) ** 2).sum(-1)

    def step(self, i: int) -> float:
        loss, grads, image = self.integrator.loss_and_grad(
            self.scene, self.values, self.params.apply, self.pixel_loss,
            seed=self.sampler_seed(i))
        with torch.profiler.record_function("optimizer"):
            for k, v in self.values.items():
                v.grad = _round(grads[k], self.round_to).to(v.device)
            self.opt.step()
        with torch.profiler.record_function("read"):
            value = float(_round(loss, self.round_to))
        if i < self.checked:
            self._note(i, value, image)
        return value

    def _note(self, i, loss, image):
        rec = self.record
        rec["loss"].append(loss)
        if i == 0:
            rec["image"] = _round(image, self.round_to).detach().cpu()
            rec["grad"] = {
                k: (self.opt.state[v]["exp_avg"] / (1 - ADAM_BETAS[0])).cpu()
                for k, v in self.values.items()}
        if i == self.checked - 1:
            rec["end"] = {k: v.detach().cpu().clone()
                          for k, v in self.values.items()}

    def answer(self):
        return None


class RenderDForwardLoop(Loop):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        name = self.mix["tangent"]
        self.tangent_name = name
        self.direction = torch.ones_like(self.values[name])
        self.last = None

    def step(self, i: int) -> float:
        name = self.tangent_name
        with fwAD.dual_level():
            dual = dict(self.values)
            dual[name] = fwAD.make_dual(self.values[name], self.direction)
            self.params.apply(dual)
            img = self.integrator.renderD(self.scene, 0,
                                          seed=self.sampler_seed(i))
            primal, tangent = fwAD.unpack_dual(img)
            primal = primal.clone()
            tangent = (torch.zeros_like(primal) if tangent is None
                       else tangent.clone())
        self.params.apply(self.values)
        self.last = (_round(primal, self.round_to),
                     _round(tangent, self.round_to))
        return float(self.last[1].sum())

    def answer(self):
        return {"primal": self.last[0].detach().cpu(),
                "tangent": self.last[1].detach().cpu()}


class FrameLoop(Loop):
    def step(self, i: int) -> float:
        img = self.integrator.renderC(self.scene, 0, seed=self.sampler_seed(i))
        self.last = _round(img, self.round_to)
        return float(self.last.sum())

    def answer(self):
        return {"image": self.last.detach().cpu()}


LOOPS = {"loss_and_grad": TrainLoop, "renderD_forward": RenderDForwardLoop,
         "renderC": FrameLoop}


def make_loop(pkg, config, mix, seed, device, **kwargs) -> Loop:
    return LOOPS[mix["entry"]](pkg, config, mix, seed, device, **kwargs)
