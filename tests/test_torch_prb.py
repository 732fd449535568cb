"""Path replay and the checkpoint policy of psdr_jit_tpu_torch's reverse-mode
renderD (``integrator/prb.py``, ``base.REMAT_MODE``), on the CPU.

The port's ``"prb"`` gradients are held to its ``"chunk"`` ones for the four
parameter classes of ``tests/test_prb.py`` (the red wall's vertices, the
radiance, the light's albedo and the camera's x position; 16x16 box, spp
4, ``PathTracer(2)``, loss ``sum(renderD^2)``, seed 7) at that test's
``rtol`` 2e-4 and ``atol`` 1e-6; both rebuild a chunk from the same taped
hit payloads, so they agree to the order of their float sums (measured
bitwise here). The checkpoint policy (each checkpointed chunk replays its
first run's payloads and, in an edge chunk, its detached radiance
difference) leaves the gradients bit for bit as they were without it
(``base._policy_tape`` patched to None) and launches no hit in the
backward sweep: ``intersect.ray_intersect_detached`` (K1, K5, K6 on the
card) and ``megakernel.li_mega_pair`` (K2 pair) are counted around
``torch.autograd.grad``. One case is held to the JAX package's own
``"prb"`` gradient at ``tests/test_torch_renderD.py``'s bound for the
radiance (5e-3; measured 6.3e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu.integrator.base as jbase
import psdr_jit_tpu_torch as pt
from chip_smoke import renderd_tangent, train_setup, renderd_weight
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.integrator import base
from psdr_jit_tpu_torch.integrator import prb
from psdr_jit_tpu_torch.ops import intersect
from psdr_jit_tpu_torch.ops import megakernel as mega
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

KINDS = ("vertices", "radiance", "albedo", "camera")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _box(w=16, spp=4, sppe=0, sppse=0):
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(make_cbox(
        width=w, height=w, spp=spp, sppe=sppe, sppse=sppse)), device=CPU)
    sc.configure()
    return sc


def _param(sc, kind):
    """``(value, set)`` of one parameter of ``tests/test_prb.py``."""
    if kind == "vertices":
        mesh = sc.meshes[-1]
        base_v = mesh.vertex_positions_raw.clone()

        def put(d):
            mesh.vertex_positions_raw = base_v + d
        return torch.zeros_like(base_v), put
    if kind == "radiance":
        em = sc.emitters[0]
        base_r = em.radiance.clone()

        def put(d):
            em.radiance = base_r + d
        return torch.zeros_like(base_r), put
    if kind == "albedo":
        b = sc.bsdfs[0]
        base_a = b.reflectance.data.clone()

        def put(d):
            b.reflectance.data = base_a + d
        return torch.zeros_like(base_a), put
    cam = sc.sensors[0]
    base_c = cam.to_world_raw.clone()
    e03 = torch.zeros(4, 4)
    e03[0, 3] = 1.0

    def put(d):
        cam.to_world_raw = base_c + d * e03
    return torch.zeros(()), put


def _grad(mode, sc, kind, integ=None, seed=7, loss=None, monkeypatch=None):
    """``(primal, gradient)`` of ``loss(renderD)`` (``sum(img^2)``) along
    ``kind`` under ``REMAT_MODE`` ``mode``."""
    integ = integ or pt.PathTracer(2)
    value, put = _param(sc, kind)
    old = base.REMAT_MODE
    base.REMAT_MODE = mode
    d = value.clone().requires_grad_()
    put(d)
    try:
        img = integ.renderD(sc, 0, seed=seed)
        out = (img * img).sum() if loss is None else loss(img)
        (g,) = torch.autograd.grad(out, d)
    finally:
        base.REMAT_MODE = old
        put(value)
    return img.detach(), g


@pytest.fixture(scope="module")
def box():
    return _box()


@pytest.mark.parametrize("kind", KINDS)
def test_prb_matches_chunk(box, kind):
    """``tests/test_prb.py test_prb_matches_remat`` in the port."""
    _, g_chunk = _grad("chunk", box, kind)
    _, g_prb = _grad("prb", box, kind)
    assert torch.isfinite(g_prb).all()
    assert (g_chunk.abs() > 0).any()
    np.testing.assert_allclose(g_prb.numpy(), g_chunk.numpy(), rtol=2e-4,
                               atol=1e-6)


def test_prb_primal_matches(box):
    """The replayed chunk's primal is the plain forward's, bit for bit."""
    a, _ = _grad("chunk", box, "radiance", seed=3)
    b, _ = _grad("prb", box, "radiance", seed=3)
    assert torch.equal(a, b)
    with torch.no_grad():  # no graph: the plain chunk, no tape
        old = base.REMAT_MODE
        base.REMAT_MODE = "prb"
        try:
            c = pt.PathTracer(2).renderD(box, 0, seed=3)
        finally:
            base.REMAT_MODE = old
    assert torch.equal(a, c)


def test_prb_depth0():
    """Depth 0: the camera hit's emission alone (``tests/test_prb.py
    test_prb_depth0``)."""
    sc = _box(w=8, spp=2)
    _, g = _grad("prb", sc, "radiance", integ=pt.PathTracer(0), seed=1,
                 loss=lambda img: img.sum())
    assert torch.isfinite(g).all() and (g > 0).any()


@pytest.mark.parametrize("mode", ["bounce", "none"])
def test_other_modes_match_chunk(box, mode):
    """``"bounce"`` (a checkpoint a bounce of the general Li) and
    ``"none"`` give the chunk checkpoint's gradient."""
    _, g_chunk = _grad("chunk", box, "vertices")
    _, g = _grad(mode, box, "vertices")
    np.testing.assert_allclose(g.numpy(), g_chunk.numpy(), rtol=2e-4,
                               atol=1e-6)


class _Counter:
    """Counts the calls of the hit and K2-pair entries."""

    def __init__(self, monkeypatch):
        self.n = 0
        for mod, name in ((intersect, "ray_intersect_detached"),
                          (mega, "li_mega_pair")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, self._wrap(fn))

    def _wrap(self, fn):
        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return counted


def _backward_calls(mode, monkeypatch, policy=True, integ=None):
    """``(forward calls, backward calls, gradients)`` of a reverse renderD
    of the 16x16 box with all three terms (sppe, sppse 4) under ``mode``,
    for the four parameters of ``train_setup``."""
    sc = _box(sppe=4, sppse=4)
    if not policy:
        monkeypatch.setattr(base, "_policy_tape", lambda: None)
    count = _Counter(monkeypatch)
    monkeypatch.setattr(base, "REMAT_MODE", mode)
    params, apply, _ = train_setup(sc)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    apply(p)
    img = (integ or pt.PathTracer(2)).renderD(sc, 0, seed=3)
    fwd = count.n
    grads = torch.autograd.grad((img * renderd_weight(256, CPU)).sum(),
                                list(p.values()))
    apply(params)
    return fwd, count.n - fwd, dict(zip(p, grads))


@pytest.mark.parametrize("mode", ["prb", "chunk"])
def test_no_hit_launch_in_the_backward_sweep(monkeypatch, mode):
    """Under path replay and under the chunk checkpoint with its policy,
    the backward sweep traces no ray and takes no K2 pair; without the
    policy the chunk checkpoint traces every chunk again."""
    fwd, bwd, _ = _backward_calls(mode, monkeypatch)
    assert fwd > 0 and bwd == 0, (fwd, bwd)
    if mode == "chunk":
        monkeypatch.undo()
        fwd0, bwd0, _ = _backward_calls(mode, monkeypatch, policy=False)
        assert fwd0 == fwd and bwd0 == fwd, (fwd0, bwd0)


def test_chunk_policy_gradients_bitwise(monkeypatch):
    """The checkpoint policy changes no bit of any gradient."""
    _, _, with_policy = _backward_calls("chunk", monkeypatch)
    monkeypatch.undo()
    _, _, without = _backward_calls("chunk", monkeypatch, policy=False)
    for k, g in with_policy.items():
        assert float(g.abs().sum()) > 0, k
        assert torch.equal(g, without[k]), k


def test_direct_keeps_the_chunk_checkpoint_under_prb(monkeypatch):
    """``Direct`` has no path replay: under ``"prb"`` its interior keeps the
    chunk checkpoint (with the policy: no hit in the backward sweep), never
    a graph held whole, and its gradients are those of ``"chunk"``
    (``tests/test_prb.py:109``)."""
    replays = []
    monkeypatch.setattr(prb, "replay_chunk",
                        lambda *a: replays.append(a) or None)
    checkpoints = []
    real = base._checkpoint
    monkeypatch.setattr(base, "_checkpoint",
                        lambda fn, *a: checkpoints.append(fn) or real(fn, *a))
    fwd, bwd, g_prb = _backward_calls("prb", monkeypatch, integ=pt.Direct(2))
    assert not replays and bwd == 0 and fwd > 0
    n_prb = len(checkpoints)
    assert n_prb >= 3  # the interior chunk and one chunk an edge pass
    monkeypatch.undo()
    _, _, g_chunk = _backward_calls("chunk", monkeypatch, integ=pt.Direct(2))
    for k, g in g_prb.items():
        assert torch.equal(g, g_chunk[k]), k


def test_forward_mode_under_prb_raises(box):
    """Path replay is reverse-mode only: a forward-mode renderD under it
    raises, and never switches to another mode quietly; ``"chunk"`` runs
    it."""
    setup = train_setup(box)
    old = base.REMAT_MODE
    base.REMAT_MODE = "prb"
    try:
        with pytest.raises(ValueError, match="reverse-mode only"):
            renderd_tangent(pt.PathTracer(2), box, setup, "tx", 1.0)
    finally:
        base.REMAT_MODE = old
    _, tangent = renderd_tangent(pt.PathTracer(2), box, setup, "tx", 1.0)
    assert float(tangent.abs().sum()) > 0


def test_prb_matches_jax_prb():
    """The radiance case against the JAX package's ``PSDR_REMAT=prb``
    gradient (its general XLA path), at ``test_torch_renderD.py``'s bound
    for the radiance."""
    jsc = make_cbox(width=16, height=16, spp=4)
    jsc.configure()
    em = jsc.emitters[0]
    base_r = jnp.asarray(em.radiance)
    integ = psdr.PathTracer(2)

    def loss(d):
        em.radiance = base_r + d
        return jnp.sum(jnp.square(integ.renderD(jsc, 0, seed=7)))

    old = jbase.REMAT_MODE, jmk.MEGA_MODE
    jbase.REMAT_MODE, jmk.MEGA_MODE = "prb", "off"
    try:
        j = np.asarray(jax.jit(jax.grad(loss))(jnp.zeros_like(base_r)))
    finally:
        jbase.REMAT_MODE, jmk.MEGA_MODE = old
        em.radiance = base_r
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sc.configure()
    _, g = _grad("prb", sc, "radiance")
    assert np.abs(j).sum() > 0
    assert _rel(g.numpy(), j) < 5e-3, _rel(g.numpy(), j)
