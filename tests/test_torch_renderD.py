"""``PathTracer.renderD`` of psdr_jit_tpu_torch (the attached general Li
with the derivative-only primary- and secondary-edge images) against the
JAX package's ``renderD``, on the CPU.

Both packages render the Cornell box at 16x16, spp 4, sppe 4, sppse 4,
``PathTracer(2)``, seed 3: the same scene (``interop.scene_to_arrays``)
and the four parameters of the training-step tests (a translation of the
light ``tx``, the tall block's raw vertex offsets ``dv``, the reflectance
of ``bsdfs[1]`` ``alb`` and the radiance ``rad``). The JAX side runs its
general XLA path (``MEGA_MODE`` "off") with the exact f32 edge adjoint
(``SPLAT_TRANSPOSE = "rows"``); one jitted ``jax.jvp`` of a function of
all four parameters serves every tangent, one jitted ``jax.grad`` the
reverse gradients. The port's forward mode is
``torch.autograd.forward_ad``, its reverse mode ``torch.autograd.grad``.

Bounds, and why (each measured on this box at seeds 1, 3 and 5; the
largest is given):

* primal: the JAX test's criterion (``tests/test_render.py:116``) for the
  port's renderD against its renderC: rel < 1e-3 on > 90% of pixels
  (measured at least 97.7%), mean within 1e-2 (at most 7.0e-4). Against
  the JAX package's renderD, rel L1 < 5e-3 (at most 1.4e-3);
* forward tangents and reverse gradients against the JAX package's:
  the two packages' camera and edge rays differ in the last bit (XLA's
  CPU backend contracts them into FMAs, ``tests/test_torch_fused.py``),
  which flips a grazing visibility test on a few lanes, and the
  secondary-edge term's lanes are heavy-tailed
  (``tests/test_torch_secondary_edges.py``: the vertex-offset gradient of
  the step there stays 7.9% from the JAX package's, bound 0.15).
  ``TANGENT_RTOL``: tx 1e-2 (measured at most 4.2e-3), dv 0.15 (4.0e-2),
  alb 3e-2 (1.2e-2), rad 5e-3 (1.4e-3);
* the port's two modes against each other (the adjoint identity
  ``sum(w * tangent) == <grad, direction>``, the same linear map
  evaluated twice): 1e-4 (at most 2.4e-5, dv at seed 5, whose random
  direction sums terms of both signs);
* renderD's reverse gradients against the port's ``loss_and_grad`` of
  the same linear loss: the interior routes differ (K3's plain version
  over K2-stash's hits, whose bounce origins are ``o + t d``, against the
  general attached Li's bilinear hit points), which flips a few grazing
  lanes (the JAX package, whose fused step takes the same route as its
  renderD on the CPU, holds the two to rtol 1e-4, ``tests/test_fused.py``).
  ``FUSED_RTOL``: tx 1e-2 (measured at most 4.9e-3), dv 5e-2 (1.7e-2),
  alb 2e-2 (8.6e-3), rad 5e-3 (7.2e-4);
* the two-light box (outside K2's scope, ``PathTracer(1)``): the tangent
  along tx within ``TANGENT_RTOL["tx"]`` (measured at most 1.3e-4);
* crops: rows of the full frame bit for bit, primal and tangent;
* ``sample_position`` and path-mode ``ray_intersect``: the point and the
  Jacobian's tangents to 1e-5 of the JAX package's on the same rows, the
  pdf without a tangent.

The file takes about 100 s serial, most of it the JAX package's two
compilations of the box's renderD (jvp and grad) and the one of the
two-light box.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import (renderd_grads, renderd_tangent, renderd_weight,
                        train_setup)
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu.shape import mesh as jmesh
from psdr_jit_tpu.core.types import Ray as JRay
from psdr_jit_tpu_torch.core.types import Ray
from psdr_jit_tpu_torch.ops import megakernel as tmk
from psdr_jit_tpu_torch.ops.gather import gather_rows
from psdr_jit_tpu_torch.ops.image import splat_add_derivative_only
from psdr_jit_tpu_torch.shape import mesh as tmesh
from scenes import LIGHT, _quads_to_mesh, make_cbox

CPU = torch.device("cpu")  # the entry points default to the card


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's renders: the tier-1 run shares
    the CPU among several pytest workers, and there torch's oversubscribed
    parallel regions made these renders 30-80x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

W, SPP, SPPE, SPPSE, DEPTH, SEED = 16, 4, 4, 4, 2, 3
PARAMS = ("tx", "dv", "alb", "rad")
WEIGHT = renderd_weight(W * W, CPU).numpy()
# forward tangent / reverse gradient against the JAX package's renderD
TANGENT_RTOL = {"tx": 1e-2, "dv": 0.15, "alb": 3e-2, "rad": 5e-3}
FUSED_RTOL = {"tx": 1e-2, "dv": 5e-2, "alb": 2e-2, "rad": 5e-3}
ADJOINT_RTOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_scene(two_lights=False):
    sc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)
    if two_lights:  # a second, dimmer light below the first
        light = _quads_to_mesh(LIGHT)
        light.to_world_raw = np.array(
            [[1.0, 0, 0, 0], [0, 1, 0, -120.0], [0, 0, 1, 0],
             [0, 0, 0, 1.0]], np.float32)
        sc.add_Mesh(light, None, "light", psdr.AreaLight([4.0, 6.0, 9.0]))
    sc.configure()
    return sc


def _directions(n_verts):
    """The tangent direction of each parameter (numpy, from a seed)."""
    rng = np.random.default_rng(2)
    return {"tx": np.float32(1.0),
            "dv": rng.standard_normal((n_verts, 3)).astype(np.float32),
            "alb": np.float32([1.0, 0.5, 0.25]),
            "rad": np.float32([1.0, 2.0, 3.0])}


def _jax_side(jsc):
    """``(p0, primal, {k: tangent}, {k: grad of sum(w * renderD)})`` of the
    JAX package's renderD at the parameters' values."""
    m0, m2 = jsc.meshes[0], jsc.meshes[2]
    base0 = jnp.asarray(m0.to_world_raw)
    verts = jnp.asarray(m2.vertex_positions_raw)
    p0 = {"tx": jnp.float32(0.0), "dv": jnp.zeros_like(verts),
          "alb": jnp.asarray(jsc.bsdfs[1].reflectance.data).reshape(-1)[:3],
          "rad": jnp.asarray(jsc.emitters[0].radiance)}

    def apply(p):
        m0.to_world_raw = base0.at[0, 3].add(p["tx"])
        m2.vertex_positions_raw = verts + p["dv"]
        jsc.bsdfs[1].reflectance.data = jnp.broadcast_to(
            p["alb"], jnp.shape(jsc.bsdfs[1].reflectance.data))
        jsc.emitters[0].radiance = p["rad"]

    integ = psdr.PathTracer(DEPTH)

    def render(p):
        apply(p)
        return integ.renderD(jsc, 0, seed=SEED)

    w = jnp.asarray(WEIGHT)
    dirs = _directions(verts.shape[0])
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        jvp = jax.jit(lambda p, t: jax.jvp(render, (p,), (t,)))
        tangents = {}
        for k in PARAMS:
            t = {j: jnp.zeros_like(v) for j, v in p0.items()}
            t[k] = jnp.asarray(dirs[k])
            primal, tangents[k] = jvp(p0, t)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(render(p) * w)))(p0)
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old
        apply(p0)
    return ({k: np.asarray(v) for k, v in p0.items()}, np.asarray(primal),
            {k: np.asarray(v) for k, v in tangents.items()},
            {k: np.asarray(v) for k, v in grads.items()})


def _port_forward(sc, k, direction, **kwargs):
    """``(primal, tangent)`` of the port's renderD along ``direction`` of
    parameter ``k`` (forward mode)."""
    return renderd_tangent(pt.PathTracer(DEPTH), sc, train_setup(sc), k,
                           direction, SEED, **kwargs)


@pytest.fixture(scope="module")
def box():
    jsc = _jax_scene()
    ref = _jax_side(jsc)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    dirs = _directions(sc.meshes[2].num_vertices)
    fwd = {k: _port_forward(sc, k, dirs[k]) for k in PARAMS}
    grads = renderd_grads(pt.PathTracer(DEPTH), sc, train_setup(sc),
                          torch.from_numpy(WEIGHT), SEED)
    return sc, ref, dirs, fwd, grads


def test_renderD_primal_matches_renderC(box):
    """The edge images are derivative-only: the primal is the interior
    term, the attached general Li; it equals renderC (K2's plain version)
    as the JAX package's renderD equals its renderC, and the JAX
    package's renderD primal up to a few flipped lanes."""
    sc, (_, j_primal, _, _), _, fwd, _ = box
    c = pt.PathTracer(DEPTH).renderC(sc, 0, seed=SEED).numpy()
    d = fwd["tx"][0].numpy()
    assert d.shape == (W * W, 3) and d.dtype == np.float32
    rel = np.abs(d - c) / (np.abs(c) + 1e-4)
    assert (rel < 1e-3).mean() > 0.9, (rel < 1e-3).mean()
    np.testing.assert_allclose(d.mean(), c.mean(), rtol=1e-2)
    assert _rel(d, j_primal) < 5e-3, _rel(d, j_primal)
    for k in PARAMS:  # forward mode changes no value
        assert torch.equal(fwd[k][0], fwd["tx"][0])


@pytest.mark.parametrize("k", PARAMS)
def test_forward_tangent_matches_jax(box, k):
    """The gradient image along each parameter's direction against the
    JAX package's ``jax.jvp`` of its renderD; each tangent is nonzero (a
    scene compile that dropped a tangent would give zeros)."""
    _, (_, _, j_tan, _), _, fwd, _ = box
    tangent = fwd[k][1].numpy()
    assert np.abs(j_tan[k]).sum() > 0 and np.abs(tangent).sum() > 0, k
    assert np.isfinite(tangent).all()
    assert _rel(tangent, j_tan[k]) < TANGENT_RTOL[k], (k, _rel(
        tangent, j_tan[k]))


def test_reverse_gradients_match_jax_and_forward_mode(box):
    """``torch.autograd.grad`` of ``sum(w * renderD)`` against the JAX
    package's ``jax.grad`` of the same, and against the port's own
    forward tangents through the adjoint identity."""
    _, (_, _, _, j_grad), dirs, fwd, grads = box
    w = torch.from_numpy(WEIGHT).double()
    for k in PARAMS:
        g = grads[k].numpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0, k
        assert _rel(g, j_grad[k]) < TANGENT_RTOL[k], (k, _rel(g, j_grad[k]))
        lhs = float((w * fwd[k][1].double()).sum())
        rhs = float((grads[k].double() * torch.as_tensor(
            dirs[k]).double()).sum())
        assert abs(lhs - rhs) <= ADJOINT_RTOL * abs(rhs), (k, lhs, rhs)


def test_reverse_gradients_match_loss_and_grad(box):
    """The training step's gradient of the same linear loss (``pixel_loss
    = (rows * w[pix]).sum(-1)``, through K3's and K4's plain versions)
    against renderD's reverse gradients (the general attached Li); the
    loss equals ``sum(w * renderC)``, whose image is the step's."""
    sc, _, _, _, grads = box
    params, apply, _ = train_setup(sc)
    w = torch.from_numpy(WEIGHT)
    loss, g, img = pt.PathTracer(DEPTH).loss_and_grad(
        sc, params, apply, lambda rows, pix: (rows * w[pix]).sum(-1),
        seed=SEED)
    assert abs(float(loss) - float((img * w).sum())) <= 1e-5 * abs(
        float(loss))
    for k in PARAMS:
        assert _rel(g[k].numpy(), grads[k].numpy()) < FUSED_RTOL[k], (
            k, _rel(g[k].numpy(), grads[k].numpy()))


def test_crop_rows_bitwise(box):
    """``pix_id`` renders those pixels' rows of the full frame bit for
    bit, in value and in tangent: the interior's lanes are global and the
    edge images are built over the full grid."""
    sc, _, dirs, fwd, _ = box
    rows = np.random.default_rng(4).permutation(W * W)[:77]
    primal, tangent = _port_forward(sc, "dv", dirs["dv"], pix_id=rows)
    idx = torch.from_numpy(rows)
    assert torch.equal(primal, fwd["dv"][0][idx])
    assert torch.equal(tangent, fwd["dv"][1][idx])


def test_out_of_scope_scene_matches_jax():
    """A second AreaLight puts the box outside K2's scope: renderD's
    primary-edge radiance then comes from two sequential general Li calls
    (the base class's ``Li_pair``). Its tangent along the light's
    translation against the JAX package's (``PathTracer(1)``, whose
    smaller graph JAX compiles faster), and the training step there runs
    through the general attached Li instead of raising."""
    jsc = _jax_scene(two_lights=True)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    assert not tmk.applicable(sc.configure())
    m0 = jsc.meshes[0]
    base0 = jnp.asarray(m0.to_world_raw)

    def render(tx):
        m0.to_world_raw = base0.at[0, 3].add(tx)
        return psdr.PathTracer(1).renderD(jsc, 0, seed=SEED)

    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        _, j_tan = jax.jvp(render, (jnp.float32(0.0),), (jnp.float32(1.0),))
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old
        m0.to_world_raw = base0
    _, tangent = renderd_tangent(pt.PathTracer(1), sc, train_setup(sc),
                                 "tx", np.float32(1.0), SEED)
    j_tan = np.asarray(j_tan)
    assert np.abs(j_tan).sum() > 0 and np.abs(tangent.numpy()).sum() > 0
    assert _rel(tangent.numpy(), j_tan) < TANGENT_RTOL["tx"], _rel(
        tangent.numpy(), j_tan)
    params, apply, loss_fn = train_setup(sc)
    loss, g, img = pt.PathTracer(DEPTH).loss_and_grad(sc, params, apply,
                                                      loss_fn, seed=SEED)
    assert bool(torch.isfinite(loss)) and img.shape == (W * W, 3)
    assert all(bool(torch.isfinite(v).all()) and float(v.abs().sum()) > 0
               for v in g.values())


@pytest.mark.parametrize("rows", [32, 1024])
def test_gather_rows_gradcheck_forward_and_reverse(rows):
    """``gather_rows`` in float64, forward and reverse mode, through both
    of its backward routes (a histogram up to ``BINCOUNT_MAX_ROWS`` rows,
    ``index_add_`` above)."""
    gen = torch.Generator().manual_seed(rows)
    table = torch.randn(rows, 3, dtype=torch.float64, generator=gen,
                        requires_grad=True)
    idx = torch.randint(0, rows, (200,), generator=gen)
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, idx), (table,),
                                    check_forward_ad=True)


def test_splat_derivative_only_gradcheck():
    """``splat_add_derivative_only``'s forward- and reverse-mode rules
    are the derivative of the scatter-add they stand for: checked on
    ``splat(v) + scatter(v).detach()``, whose value is the scatter's."""
    gen = torch.Generator().manual_seed(0)
    values = torch.randn(300, 3, dtype=torch.float64, generator=gen,
                         requires_grad=True)
    idx = torch.randint(-1, 40, (300,), generator=gen)

    def scatter(v):
        ok = idx >= 0
        return torch.zeros(40, 3, dtype=v.dtype).index_add(
            0, idx[ok], v[ok])

    assert torch.autograd.gradcheck(
        lambda v: splat_add_derivative_only(v, idx, 40)
        + scatter(v.detach()), (values,), check_forward_ad=True)


def _jax_light_sample(jsc, dv):
    """``(p, J, pdf)`` of the JAX package's ``sample_position`` on the
    light mesh with vertex offsets ``dv``."""
    light = jsc.meshes[0]
    md = light.configure_data(
        vertex_positions_raw=jnp.asarray(light.vertex_positions_raw) + dv)
    u = np.random.default_rng(3).random((64, 2)).astype(np.float32)
    ps = jmesh.sample_position(md, jnp.asarray(u))
    return ps.p, ps.J, ps.pdf


def test_sample_position_jacobian_and_pdf_match_jax():
    """The material-form Jacobian ``face_area / detach(face_area)`` and
    the detached pdf of ``sample_position``: their tangents along the
    light's vertex offsets against the JAX package's, on the same rows
    (the point's too)."""
    jsc = _jax_scene()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    light = sc.meshes[0]
    dv = np.random.default_rng(5).standard_normal(
        (light.num_vertices, 3)).astype(np.float32)
    _, j_tan = jax.jvp(lambda d: _jax_light_sample(jsc, d),
                       (jnp.zeros(dv.shape, jnp.float32),), (jnp.asarray(dv),))
    base = light.vertex_positions_raw
    u = torch.from_numpy(np.random.default_rng(3).random((64, 2)).astype(
        np.float32))
    with fwAD.dual_level():
        light.vertex_positions_raw = fwAD.make_dual(base,
                                                    torch.from_numpy(dv))
        ps = tmesh.sample_position(light.configure_data(), u)
        tans = [fwAD.unpack_dual(x).tangent for x in (ps.p, ps.J, ps.pdf)]
    light.vertex_positions_raw = base
    assert tans[2] is None and float(np.abs(j_tan[2]).max()) == 0.0
    assert float(np.abs(j_tan[1]).sum()) > 0
    for got, want in zip(tans[:2], j_tan[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_path_mode_jacobian_matches_jax():
    """``SceneData.ray_intersect``'s path-mode ``J``: its tangent along
    the tall block's vertex offsets against the JAX package's on the same
    hits; solid mode keeps ``J = 1``."""
    jsc = _jax_scene()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    block = sc.meshes[2]
    dv = np.random.default_rng(6).standard_normal(
        (block.num_vertices, 3)).astype(np.float32)
    rng = np.random.default_rng(7)
    o = np.tile(np.float32([278.0, 273.0, -800.0]), (256, 1))
    d = np.stack([rng.uniform(-0.25, 0.25, 256), rng.uniform(-0.25, 0.25, 256),
                  np.ones(256)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jblock = jsc.meshes[2]
    jbase = jnp.asarray(jblock.vertex_positions_raw)

    def jax_j(dd):
        jblock.vertex_positions_raw = jbase + dd
        its = jsc.configure_data().ray_intersect(
            JRay(jnp.asarray(o), jnp.asarray(d)), mode="path")
        return its.J, its.tri_id

    (j_val, j_ids), (j_tan, _) = jax.jvp(
        jax_j, (jnp.zeros(dv.shape, jnp.float32),), (jnp.asarray(dv),))
    jblock.vertex_positions_raw = jbase
    base = block.vertex_positions_raw
    with fwAD.dual_level():
        block.vertex_positions_raw = fwAD.make_dual(base,
                                                    torch.from_numpy(dv))
        sd = sc.configure_data()
        ray = Ray(torch.from_numpy(o), torch.from_numpy(d))
        its = sd.ray_intersect(ray, mode="path")
        val, tan = fwAD.unpack_dual(its.J)
        solid = fwAD.unpack_dual(sd.ray_intersect(ray, mode="solid").J)
    block.vertex_positions_raw = base
    np.testing.assert_array_equal(its.tri_id.numpy(), np.asarray(j_ids))
    assert float(np.abs(np.asarray(j_tan)).sum()) > 0
    np.testing.assert_allclose(val.numpy(), np.asarray(j_val), rtol=1e-6)
    np.testing.assert_allclose(tan.numpy(), np.asarray(j_tan), rtol=1e-5,
                               atol=1e-7)
    assert torch.equal(solid.primal, torch.ones(256)) and solid.tangent is None
