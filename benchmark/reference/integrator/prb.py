"""Path replay for the interior term's reverse mode, and the intersection
tape behind it (counterpart of ``psdr_jit_tpu/integrator/prb.py``).

An :class:`IntersectTape` records the detached payload ``(tri_id, valid,
uv)`` of each ``SceneData.ray_intersect`` in call order and, replaying,
hands them back without a kernel launch: the path formulation rebuilds an
attached hit from the payload and the scene's tables alone, so no ray is
traced again. Two users:

* ``PSDR_REMAT=prb`` (``base.REMAT_MODE``): :func:`replay_chunk` renders
  an interior chunk of a reverse-mode ``renderD`` under a
  ``torch.autograd.Function`` whose forward holds no graph and records the
  tape, and whose backward rebuilds the attached chunk from the tape and
  pulls the image cotangent back into the scene's tensors. The chunk is
  replayed whole, so the gradient is the exact chain of the attached Li
  (the cross-bounce position and frame chains that classic path replay
  drops are kept). Reverse mode only: a forward-mode render under it
  raises, as the JAX package's ``custom_vjp`` refuses ``jvp``;
* the checkpoint policy of every checkpointed chunk (``base._checkpoint``,
  the JAX package's ``CHECKPOINT_POLICY``): the chunk's first run records
  the tape, its recompute in the backward sweep replays it (the ambient
  tape of :func:`recording`, which ``ray_intersect`` reads when it is
  given none). An edge chunk's detached radiance difference is taped the
  same way (:func:`taped_value`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.forward_ad as fwAD

from ..scene.scene import tree_map


class IntersectTape:
    """Detached payloads in call order: appended while recording, handed
    back from the start while replaying."""

    __slots__ = ("items", "cursor", "replaying")

    def __init__(self):
        self.items = []
        self.cursor = 0
        self.replaying = False

    def append(self, payload):
        self.items.append(payload)

    def pop(self):
        p = self.items[self.cursor]
        self.cursor += 1
        return p

    def rewind(self) -> "IntersectTape":
        """Switch to replaying from the first payload."""
        self.replaying = True
        self.cursor = 0
        return self


_AMBIENT = [None]  # the tape of the innermost running checkpointed chunk


def current_tape():
    return _AMBIENT[-1]


@contextlib.contextmanager
def recording(tape):
    """Make ``tape`` the ambient tape of the block (None: no tape); on exit
    it is rewound, so every later run of the same block replays it."""
    _AMBIENT.append(tape)
    try:
        yield
    finally:
        _AMBIENT.pop()
        if tape is not None:
            tape.rewind()


def taped_value(fn, sampler):
    """``fn()``, a detached value that draws from ``sampler``, through the
    ambient tape: recorded (with the sampler's counter after it) on the
    first run, handed back on a replay; the hits ``fn`` traces are not
    taped themselves."""
    tape = current_tape()
    if tape is None:
        return fn()
    if tape.replaying:
        value, sampler.cnt = tape.pop()
        return value
    with recording(None):
        value = fn()
    tape.append((value, sampler.cnt))
    return value


def attached(sd) -> list:
    """The distinct tensors of ``sd`` that require grad, in tree order."""
    seen = {}

    def note(t):
        if t.requires_grad:
            seen.setdefault(id(t), t)
        return t

    tree_map(note, sd)
    return list(seen.values())


def has_tangent(sd) -> bool:
    """Whether a tensor of ``sd`` carries a forward-mode tangent."""
    found = []

    def note(t):
        if fwAD.unpack_dual(t).tangent is not None:
            found.append(t)
        return t

    tree_map(note, sd)
    return bool(found)


class _ReplayChunk(torch.autograd.Function):
    """``render(sd, pix_chunk, tape)`` with a backward that replays it."""

    @staticmethod
    def forward(ctx, render, sd, pix_chunk, *inputs):
        tape = IntersectTape()
        out = render(sd, pix_chunk, tape)  # grad mode is off in a forward
        ctx.state = (render, sd, pix_chunk, tape, [id(t) for t in inputs])
        return out

    @staticmethod
    def backward(ctx, g):
        render, sd, pix_chunk, tape, ids = ctx.state
        leaves = {}

        def leaf(t):
            if id(t) in ids:
                if id(t) not in leaves:
                    leaves[id(t)] = t.detach().requires_grad_()
                return leaves[id(t)]
            return t

        sd_leaf = tree_map(leaf, sd)
        with torch.enable_grad():
            out = render(sd_leaf, pix_chunk, tape.rewind())
        grads = torch.autograd.grad(out, [leaves[i] for i in ids], g,
                                    allow_unused=True)
        return (None, None, None, *grads)


def replay_chunk(render, sd, pix_chunk):
    """One interior chunk ``render(sd, pix_chunk, tape) -> (m, 3)`` in
    path-replay reverse mode: no graph is held, only the tape, and the
    backward sweep rebuilds the attached chunk from it with no hit kernel.
    Raises where ``sd`` carries forward-mode tangents."""
    if has_tangent(sd):
        raise ValueError("PSDR_REMAT=prb is reverse-mode only: a forward-"
                         "mode renderD cannot replay its paths; set "
                         "PSDR_REMAT=chunk")
    inputs = attached(sd) if torch.is_grad_enabled() else []
    if not inputs:
        return render(sd, pix_chunk, None)
    return _ReplayChunk.apply(render, sd, pix_chunk, *inputs)
