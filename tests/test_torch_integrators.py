"""The other integrators of psdr_jit_tpu_torch (``Direct``,
``CollocatedIntegrator``, ``FieldExtractionIntegrator``) against the JAX
package's, on the CPU.

Both packages render the Cornell box at 16x16, spp 4, seed 3, from the same
scene (``interop.scene_to_arrays``); the JAX side runs its general XLA path
(``MEGA_MODE`` "off") with the exact f32 edge adjoint (``SPLAT_TRANSPOSE =
"rows"``). Each JAX computation is made once, in a module fixture, and
the JAX renders of a scene share one jitted function.

Bounds, and why (measured values beside them):

* renderC of ``Direct(0|1|2)`` and ``CollocatedIntegrator``: both packages
  draw the same samples, so the images agree lane for lane up to the last
  bits of the camera rays (XLA's CPU backend contracts them into FMAs):
  rel L1 < 1e-5 (measured at most 1.3e-6, ``Direct(1)`` bitwise);
* every field of ``FieldExtractionIntegrator``, and the filtered ones:
  rel L1 < 1e-6 (measured at most 4.6e-8 for the float fields; the
  integer-valued ones, segmentation, silhouette and the normals, equal);
* the reverse renderD of ``CollocatedIntegrator`` along the reflectance:
  rel L1 1e-5 (measured 1.9e-7);
* ``Direct(2).loss_and_grad`` with sppe 4 and sppse 4, fed the JAX
  package's camera and edge rays and its secondary-edge table: the step's
  interior is the attached general Li, the route of renderD (``Direct``
  never takes the megakernels), whose solid-angle re-intersection XLA
  contracts into FMAs; a few grazing lanes flip, as between the two
  packages' renderDs. So the step is held at ``test_torch_renderD.py``'s
  bounds: image 5e-3 (measured 9.1e-4), loss 2e-4 (5.8e-5), and
  ``TANGENT_RTOL``: tx 1e-2 (1.0e-4), dv 0.15 (0.126, most of it the
  secondary-edge term's grazing receiver lanes,
  ``test_torch_secondary_edges.py``), alb 3e-2 (1.9e-2), rad 5e-3
  (4.1e-5). (``test_torch_fused.py``'s 5e-6 on the JAX rays holds only
  through the megakernels' interpreted route.)
* the direct render of a quad under a 40x64 environment map, whose
  9,828-cell importance table draws an alias coin in next-event
  estimation, with the JAX package's table: rel L1 < 1e-5 (measured at
  most 1.6e-7); its silhouette, uv and segmentation fields equal the JAX
  package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import train_setup, renderd_weight
from psdr_jit_tpu.core import transform as jxf
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from scenes import make_cbox
from test_torch_fused import TARGET, _feed_jax_rays
from test_torch_secondary_edges import _jax_table
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

W, SPP, SPPE, SPPSE, SEED = 16, 4, 4, 4, 3
INTENSITY = 2.0e5
FIELDS = ("bsdf", "segmentation", "silhouette", "position", "depth",
          "geoNormal", "shNormal", "uv", "silhouette tall_block",
          "segmentation obj:2")
RENDERS = {"Direct(0)": lambda m: m.Direct(0),
           "Direct(1)": lambda m: m.Direct(1),
           "Direct(2)": lambda m: m.Direct(2),
           "Collocated": lambda m: m.CollocatedIntegrator(INTENSITY),
           **{f: (lambda f: lambda m: m.FieldExtractionIntegrator(f))(f)
              for f in FIELDS}}
STEP_RTOL = {"tx": 1e-2, "dv": 0.15, "alb": 3e-2, "rad": 5e-3}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_modes(fn):
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        return fn()
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old


def _boxes():
    """``(jax box, port box)``: 16x16, spp/sppe/sppse 4, the tall block
    (mesh 2) named ``tall_block``."""
    jsc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)
    jsc.meshes[2].id = "tall_block"
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sc.meshes[2].id = "tall_block"
    sc.configure()
    return jsc, sc


def _jax_renders(jsc, integrators: dict) -> dict:
    """renderC of each of ``integrators`` on ``jsc`` (seed ``SEED``), all
    in one jitted function: one compilation instead of one each, the same
    images (``Integrator.render_impl`` is what ``renderC`` jits)."""
    sd = jax.lax.stop_gradient(jsc.data)
    out = jax.jit(lambda sd, seed: {
        k: i.render_impl(sd, jsc.opts, 0, seed, None, "C")
        for k, i in integrators.items()})(sd, jnp.uint32(SEED))
    return {k: np.asarray(v) for k, v in out.items()}


def _collocated_grad(jsc, w):
    """The JAX package's gradient of ``sum(w * renderD)`` of the collocated
    integrator along ``bsdfs[1]``'s reflectance."""
    b = jsc.bsdfs[1]
    a0 = jnp.asarray(b.reflectance.data).reshape(-1)[:3]
    shape = jnp.shape(b.reflectance.data)
    integ = psdr.CollocatedIntegrator(INTENSITY)

    def loss(a):
        b.reflectance.data = jnp.broadcast_to(a, shape)
        return jnp.sum(integ.renderD(jsc, 0, seed=SEED) * jnp.asarray(w))

    try:
        return np.asarray(jax.jit(jax.grad(loss))(a0))
    finally:
        b.reflectance.data = jnp.broadcast_to(a0, shape)


def _direct_step():
    """The JAX package's ``Direct(2).loss_and_grad`` on the box with the
    four parameters of ``test_torch_fused.py``: ``(loss, grads, image,
    p0)``, and its secondary-edge table."""
    sc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)
    sc.configure()
    table = _jax_table(jax.lax.stop_gradient(sc.data).sec_edge_distrb)
    m0, m2 = sc.meshes[0], sc.meshes[2]
    base0 = jnp.asarray(m0.to_world_raw)
    verts = jnp.asarray(m2.vertex_positions_raw)
    tgt = jnp.asarray(TARGET)

    def apply(p):
        m0.to_world_raw = base0.at[0, 3].add(p["tx"])
        m2.vertex_positions_raw = verts + p["dv"]
        sc.bsdfs[1].reflectance.data = jnp.broadcast_to(
            p["alb"], jnp.shape(sc.bsdfs[1].reflectance.data))
        sc.emitters[0].radiance = p["rad"]

    p0 = {"tx": jnp.float32(0.0), "dv": jnp.zeros_like(verts),
          "alb": jnp.asarray(sc.bsdfs[1].reflectance.data).reshape(-1)[:3],
          "rad": jnp.asarray(sc.emitters[0].radiance)}
    loss, g, img = psdr.Direct(2).loss_and_grad(
        sc, p0, apply,
        lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
        seed=SEED)
    return (float(loss), {k: np.asarray(v) for k, v in g.items()},
            np.asarray(img), {k: np.asarray(v) for k, v in p0.items()},
            table)


def _jax_plane():
    """A UV-mapped diffuse quad at z = 0 under a random 40x64 environment
    map (its importance table has 9,828 cells: alias rows and a coin),
    seen from above by an orthographic camera whose film reaches past the
    quad, so that the outer pixels see the map's bounding mesh."""
    sc = psdr.Scene()
    sc.opts = psdr.RenderOption(W, W, SPP, 0, 0)
    cam = psdr.OrthographicCamera(0.1, 100.0)
    cam.to_world = np.asarray(jxf.look_at([0.0, 0.0, 10.0], [0.0, 0.0, 0.0],
                                          [0.0, 1.0, 0.0]), np.float32)
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.DiffuseBSDF([0.6, 0.6, 0.6]), "rho")
    quad = psdr.Mesh()
    quad.use_face_normals = True
    quad.enable_edges = False
    quad.load_raw(np.float32([[-0.6, -0.6, 0], [0.6, -0.6, 0],
                              [0.6, 0.6, 0], [-0.6, 0.6, 0]]),
                  np.int32([[0, 1, 2], [0, 2, 3]]),
                  np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]),
                  np.int32([[0, 1, 2], [0, 2, 3]]))
    sc.add_Mesh(quad, None, "rho")
    sky = np.random.default_rng(5).uniform(0.2, 3.0, (40, 64, 3))
    sc.add_EnvironmentMap(psdr.EnvironmentMap(sky.astype(np.float32)))
    sc.configure()
    return sc


def _port_plane(jplane):
    """The quad scene in the port, sampling the JAX package's importance
    table (``atan2``, ``sin`` round differently by backend)."""
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jplane, cell_table=True),
                              device=CPU)
    sc.configure()
    return sc


@pytest.fixture(scope="module")
def ref():
    """Every JAX computation of the file, once."""
    jsc, sc = _boxes()
    w = renderd_weight(W * W, CPU).numpy()

    def run():
        renders = _jax_renders(jsc, {k: mk(psdr)
                                     for k, mk in RENDERS.items()})
        plane = _jax_plane()
        on_plane = _jax_renders(plane, {
            **{f: psdr.FieldExtractionIntegrator(f)
               for f in ("silhouette", "uv", "segmentation")},
            **{f"Direct({mis})": psdr.Direct(mis) for mis in (0, 2)}})
        return dict(renders=renders, plane=_port_plane(plane),
                    plane_fields={k: v for k, v in on_plane.items()
                                  if not k.startswith("Direct")},
                    env_renders={mis: on_plane[f"Direct({mis})"]
                                 for mis in (0, 2)},
                    colloc_grad=_collocated_grad(jsc, w),
                    step=_direct_step())

    return dict(sc=sc, w=w, **_jax_modes(run))


@pytest.mark.parametrize("name", list(RENDERS))
def test_renderc_matches_jax(ref, name):
    """renderC of each integrator (and each field) against the JAX
    package's, on the same scene and seed."""
    img = RENDERS[name](pt).renderC(ref["sc"], 0, seed=SEED)
    j = ref["renders"][name]
    assert img.shape == (W * W, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    bound = 1e-5 if name.startswith(("Direct", "Collocated")) else 1e-6
    assert _rel(img.numpy(), j) < bound, (name, _rel(img.numpy(), j))
    if name not in ("uv",):  # the box has no texture coordinates
        assert float(img.abs().sum()) > 0, name


def test_field_filters_select_objects(ref):
    """The per-object filter keeps the named mesh's hits only: by its
    ``Mesh.id`` (``SceneData.mesh_ids``) and by index (``obj:<k>``), the
    same mesh; its silhouette is a part of the whole one."""
    sc = ref["sc"]
    assert sc.data.mesh_ids[2] == "tall_block"
    by_id = pt.FieldExtractionIntegrator("silhouette tall_block").renderC(
        sc, 0, seed=SEED)
    by_k = pt.FieldExtractionIntegrator("silhouette obj:2").renderC(
        sc, 0, seed=SEED)
    whole = pt.FieldExtractionIntegrator("silhouette").renderC(sc, 0,
                                                               seed=SEED)
    seg = pt.FieldExtractionIntegrator("segmentation").renderC(sc, 0,
                                                               seed=SEED)
    assert torch.equal(by_id, by_k)
    assert 0 < float(by_id.mean()) < 0.5 * float(whole.mean())
    inside = by_id[:, 0] == 1.0  # every sample of the pixel on the block
    assert bool(inside.any())
    assert torch.equal(seg[inside, 0], torch.full_like(seg[inside, 0], 2.0))
    with pytest.raises(ValueError, match="Unsupported field"):
        pt.FieldExtractionIntegrator("albedo")


def test_fields_skip_the_sky_box(ref):
    """Under an environment map, the pixels past the quad see the bounding
    mesh, which has no BSDF: every field is 0 there; on the quad the
    silhouette is 1, the uv field its texture coordinates; both as the
    JAX package's."""
    plane = ref["plane"]
    sil = pt.FieldExtractionIntegrator("silhouette").renderC(plane, 0,
                                                             seed=SEED)
    frac = float(sil[:, 0].mean())
    assert 0.2 < frac < 0.9, frac
    for f, j in ref["plane_fields"].items():
        img = pt.FieldExtractionIntegrator(f).renderC(plane, 0, seed=SEED)
        assert _rel(img.numpy(), j) < 1e-6, (f, _rel(img.numpy(), j))
        assert torch.equal(img[sil[:, 0] == 0], torch.zeros_like(
            img[sil[:, 0] == 0])), f
    uv = pt.FieldExtractionIntegrator("uv").renderC(plane, 0, seed=SEED)
    assert float(uv[sil[:, 0] > 0, :2].mean()) == pytest.approx(0.5,
                                                                abs=0.05)


def test_collocated_renderd_matches_jax(ref):
    """The reverse renderD of the collocated integrator along the box's
    reflectance against the JAX package's ``jax.grad``; its primal is
    renderC's image."""
    sc, w = ref["sc"], torch.from_numpy(ref["w"])
    b = sc.bsdfs[1]
    a0 = b.reflectance.data.reshape(3).clone()
    a = a0.clone().requires_grad_()
    b.reflectance.data = a.reshape(1, 1, 3)
    try:
        img = pt.CollocatedIntegrator(INTENSITY).renderD(sc, 0, seed=SEED)
        (g,) = torch.autograd.grad((img * w).sum(), a)
    finally:
        b.reflectance.data = a0.reshape(1, 1, 3)
    c = pt.CollocatedIntegrator(INTENSITY).renderC(sc, 0, seed=SEED)
    assert _rel(img.detach().numpy(), c.numpy()) < 1e-5
    assert np.abs(g.numpy()).sum() > 0
    assert _rel(g.numpy(), ref["colloc_grad"]) < 1e-5, (
        g.numpy(), ref["colloc_grad"])


def test_collocated_intensity():
    """``m_intensity`` takes a scalar for all three channels or an RGB
    triple; the image is linear in it (a factor of 2 is exact)."""
    jsc = make_cbox(width=8, height=8, spp=2)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sc.configure()
    integ = pt.CollocatedIntegrator(1.0e5)
    assert torch.equal(integ.m_intensity, torch.full((3,), 1.0e5))
    a = integ.renderC(sc, 0, seed=1)
    integ.m_intensity = 2.0e5
    assert torch.equal(integ.renderC(sc, 0, seed=1), 2.0 * a)
    integ.m_intensity = [1.0e5, 2.0e5, 4.0e5]
    assert torch.equal(integ.intensity, torch.tensor([1.0e5, 2.0e5, 4.0e5]))
    assert torch.equal(integ.renderC(sc, 0, seed=1),
                       a * torch.tensor([1.0, 2.0, 4.0]))


def test_direct_loss_and_grad_on_jax_rays_matches_jax(ref, monkeypatch):
    """``Direct(2).loss_and_grad`` with the primary- and secondary-edge
    terms, fed the JAX package's rays and edge table, against the JAX
    package's step (bounds in the module docstring)."""
    j_loss, j_grads, j_img, p0, table = ref["step"]
    _feed_jax_rays(monkeypatch)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(make_cbox(
        width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)), device=CPU)
    sc._sec_edge_distrb_cache = table
    _, apply, loss_fn = train_setup(sc, seed=0)
    loss, grads, img = pt.Direct(2).loss_and_grad(
        sc, pt.params_to_torch(p0, device=CPU), apply, loss_fn, seed=SEED)
    assert abs(float(loss) - j_loss) <= 2e-4 * abs(j_loss)
    assert _rel(img.numpy(), j_img) < 5e-3, _rel(img.numpy(), j_img)
    for k, j in j_grads.items():
        g = grads[k].numpy()
        assert g.shape == j.shape and np.isfinite(g).all(), k
        assert np.abs(g).sum() > 0, k
        assert _rel(g, j) < STEP_RTOL[k], (k, _rel(g, j))


def test_direct_envmap_takes_the_alias_coin(ref):
    """``Direct(0)`` and ``Direct(2)`` on the quad under the environment
    map, whose importance table samples by alias rows: next-event
    estimation draws the coin, in the JAX package's order, so with the JAX
    package's table the images agree lane for lane."""
    sc = ref["plane"]
    assert sc.data.emitter_coin_needed
    for mis, j in ref["env_renders"].items():
        img = pt.Direct(mis).renderC(sc, 0, seed=SEED).numpy()
        assert np.abs(img).sum() > 0
        assert _rel(img, j) < 1e-5, (mis, _rel(img, j))
