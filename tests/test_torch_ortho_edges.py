"""The orthographic camera of psdr_jit_tpu_torch against the JAX
package's, and the JAX package's closed-form boundary oracles
(``tests/test_grad_edges.py``) run through the port's ``renderD`` in
forward mode (``torch.autograd.forward_ad``), with the same scenes, seeds
and bounds:

* primary edge: an emissive quad partially covering an orthographic view;
  ``d mean / d tx = L / 2`` exactly (the screen coverage's derivative);
* secondary edge: a straight occluder edge between a small light and a
  diffuse receiver; the shadow boundary's velocity and the irradiance
  jump are known in closed form.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import forward_mode
from psdr_jit_tpu.core import transform as jxf
from psdr_jit_tpu.sensor.sensor import sample_primary_edge as j_sample_pe
from psdr_jit_tpu_torch.core import transform as xf
from psdr_jit_tpu_torch.sensor.sensor import sample_primary_edge
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card


def _quad_mesh(v0, v1, v2, v3, flip=False, edges=True):
    """Planar quad with normal = cross(v1 - v0, v2 - v0) (flip reverses)."""
    m = pt.Mesh()
    m.use_face_normals = True
    m.enable_edges = edges
    faces = [[0, 1, 2], [0, 2, 3]] if not flip else [[0, 2, 1], [0, 3, 2]]
    m.load_raw(np.asarray([v0, v1, v2, v3], np.float32),
               np.asarray(faces, np.int32))
    return m


def _ortho_cam(center_xy, z):
    cam = pt.OrthographicCamera(0.1, 100.0)
    cam.to_world = xf.look_at([center_xy[0], center_xy[1], z],
                              [center_xy[0], center_xy[1], 0.0],
                              [0.0, 1.0, 0.0])
    return cam


def _mean_tangent(sc, mesh, integ, seeds, attr="to_world_raw", tangent=None):
    """Mean over ``seeds`` of the forward-mode derivative of the image's
    mean along ``tangent`` of ``mesh.<attr>`` (default: the translation
    along x of ``to_world_raw``)."""
    if tangent is None:
        tangent = torch.zeros(4, 4)
        tangent[0, 3] = 1.0
    return float(np.mean([
        float(forward_mode(integ, sc, lambda v: setattr(mesh, attr, v),
                           getattr(mesh, attr), tangent, seed)[1].mean())
        for seed in seeds]))


# ---------------------------------------------------------------------------
# the camera against the JAX package's
# ---------------------------------------------------------------------------

def _jax_shadow_scene():
    sc = psdr.Scene()
    sc.opts.width, sc.opts.height = 24, 16
    sc.opts.spp, sc.opts.sppe, sc.opts.sppse = 1, 4, 0
    cam = psdr.OrthographicCamera(0.1, 100.0)
    cam.to_world = np.asarray(jxf.look_at([2.5, 0.3, 10.0], [2.0, 0.0, 0.0],
                                          [0.0, 1.0, 0.0]), np.float32)
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.DiffuseBSDF([0.8, 0.8, 0.8]), "rho")
    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    for v, flip, bsdf, em in (
            ([[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]], False,
             "rho", None),
            ([[-0.5, -0.5, 4], [0.5, -0.5, 4], [0.5, 0.5, 4], [-0.5, 0.5, 4]],
             True, "black", psdr.AreaLight([10.0, 10.0, 10.0])),
            ([[-1, -3, 2], [1, -3, 2.5], [1, 3, 2], [-1, 3, 2.5]], False,
             "black", None)):
        m = psdr.Mesh()
        m.use_face_normals = True
        m.load_raw(np.asarray(v, np.float32),
                   np.asarray([[0, 2, 1], [0, 3, 2]] if flip
                              else [[0, 1, 2], [0, 2, 3]], np.int32))
        sc.add_Mesh(m, None, bsdf, em)
    sc.configure()
    return sc


@pytest.fixture(scope="module")
def ortho_pair():
    jsc = _jax_shadow_scene()
    arrays = pt.scene_to_arrays(jsc)
    sc = pt.Scene.from_arrays(arrays, device=CPU)
    return jsc, arrays, sc, sc.configure()


def test_interop_carries_orthographic_camera(ortho_pair):
    """``sensor.{s}.kind`` carries the camera's class across and back; a
    perspective camera writes no kind (the file format before it)."""
    jsc, arrays, sc, _ = ortho_pair
    assert str(arrays["sensor.0.kind"]) == "OrthographicCamera"
    cam = sc.sensors[0]
    assert isinstance(cam, pt.OrthographicCamera)
    assert (cam.near_clip, cam.far_clip) == (0.1, 100.0)
    np.testing.assert_array_equal(cam.to_world.numpy(),
                                  np.asarray(jsc.sensors[0].to_world))
    again = pt.scene_to_arrays(sc)
    assert sorted(again) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(again[k]), arrays[k],
                                      err_msg=k)
    from scenes import make_cbox
    assert not any(k.endswith(".kind")
                   for k in pt.scene_to_arrays(make_cbox(8, 8, 1)))


def test_orthographic_sensor_matches_jax(ortho_pair):
    """The port's orthographic SensorData against the JAX package's on
    one camera: its matrices and importance, the parallel camera rays,
    ``sample_direct`` (constant ``inv_area`` importance) and the
    primary-edge table (the classification against the view direction,
    equal; the endpoints to f32 rounding)."""
    jsc, _, _, sd = ortho_pair
    import jax
    js, ts = jax.lax.stop_gradient(jsc.data).sensors[0], sd.sensors[0]
    assert ts.ortho and js.ortho
    for f in ("sample_to_camera", "world_to_sample", "to_world",
              "camera_pos", "camera_dir", "inv_area"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    rng = np.random.default_rng(0)
    q = rng.random((500, 2)).astype(np.float32)
    jr = js.sample_primary_ray(jnp.asarray(q))
    tr = ts.sample_primary_ray(torch.from_numpy(q))
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d), rtol=1e-6,
                               atol=1e-7)
    p = np.concatenate([rng.uniform(0.5, 4.5, (500, 1)),
                        rng.uniform(-2.0, 2.0, (500, 1)),
                        rng.uniform(-1.0, 1.0, (500, 1))], 1).astype(
                            np.float32)
    jd, td = js.sample_direct(jnp.asarray(p)), ts.sample_direct(
        torch.from_numpy(p))
    np.testing.assert_array_equal(td.pixel_idx.numpy(),
                                  np.asarray(jd.pixel_idx))
    np.testing.assert_array_equal(td.is_valid.numpy(),
                                  np.asarray(jd.is_valid))
    np.testing.assert_allclose(td.sensor_val.numpy(),
                               np.asarray(jd.sensor_val), rtol=1e-6)
    np.testing.assert_allclose(td.q.numpy(), np.asarray(jd.q), rtol=1e-5,
                               atol=1e-6)
    je, te = js.edge_info, ts.edge_info
    np.testing.assert_array_equal(te.edge_length.numpy() > 0,
                                  np.asarray(je.edge_length) > 0)
    assert int((te.edge_length > 0).sum()) > 0
    for f in ("p0", "p1", "edge_normal", "edge_length"):
        np.testing.assert_allclose(getattr(te, f).numpy(),
                                   np.asarray(getattr(je, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    u = rng.random(300).astype(np.float32)
    jes = j_sample_pe(js, jnp.asarray(u))
    tes = sample_primary_edge(ts, torch.from_numpy(u))
    np.testing.assert_array_equal(tes.idx.numpy(), np.asarray(jes.idx))
    np.testing.assert_allclose(tes.ray_p.o.numpy(), np.asarray(jes.ray_p.o),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# primary edges (tests/test_grad_edges.py:47-139)
# ---------------------------------------------------------------------------

def _primary_edge_scene(x0=0.3, w=64, sppe=8):
    """Emissive quad z=5 spanning x in [-2, x0], y in [-2, 2]; an
    orthographic camera at the origin looking +z over x, y in [-1, 1]^2."""
    sc = pt.Scene(device=CPU)
    sc.opts = pt.RenderOption(w, w, 4, sppe, 0)
    sc.add_Sensor(pt.OrthographicCamera(0.1, 100.0))
    sc.add_BSDF(pt.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    light = _quad_mesh([-2, -2, 5], [x0, -2, 5], [x0, 2, 5], [-2, 2, 5],
                       flip=True)
    sc.add_Mesh(light, None, "black", pt.AreaLight([1.0, 1.0, 1.0]))
    return sc, light


def test_primary_edge_primal_coverage():
    sc, _ = _primary_edge_scene(x0=0.3)
    sc.configure()
    img = pt.PathTracer(0).renderC(sc, 0, seed=0).numpy()
    # covered sample-space fraction = (x0 + 1) / 2 = 0.65
    np.testing.assert_allclose(img.mean(), 0.65, atol=0.01)


def test_primary_edge_gradient_analytic():
    """d(mean)/d(tx) = L * d(coverage)/d(tx) = 1/2 exactly."""
    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=16)
    sc.configure()
    g = _mean_tangent(sc, light, pt.PathTracer(0), range(4))
    np.testing.assert_allclose(g, 0.5, rtol=0.05)


def test_primary_edge_interior_alone_misses_gradient():
    """Without sppe the translation gradient is ~0: the edge term is what
    carries it."""
    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=8)
    sc.opts.sppe = 0
    sc.configure()
    g = _mean_tangent(sc, light, pt.PathTracer(0), [0])
    assert abs(g) < 0.01


def test_primary_edge_vertex_gradient():
    """The same derivative with respect to raw vertex positions: the two
    vertices of the x0 edge (1 and 2) move in +x."""
    sc, light = _primary_edge_scene(x0=0.3, w=64, sppe=16)
    sc.configure()
    tang = torch.zeros(4, 3)
    tang[1, 0] = tang[2, 0] = 1.0
    g = _mean_tangent(sc, light, pt.PathTracer(0), range(4),
                      attr="vertex_positions_raw", tangent=tang)
    np.testing.assert_allclose(g, 0.5, rtol=0.06)


# ---------------------------------------------------------------------------
# secondary edges (tests/test_grad_edges.py:205-298)
# ---------------------------------------------------------------------------

def _shadow_scene(w=32, sppse=32, light_half=0.05, rho=0.8, L=200.0):
    """Receiver plane z=0, small light at (0,0,4) facing down, occluder
    quad z=2 spanning x in [-1,1]; the camera views x in [1.5,3.5], y in
    [-1,1] from z=10 straight down (outside the occluder's footprint)."""
    sc = pt.Scene(device=CPU)
    sc.opts = pt.RenderOption(w, w, 4, 0, sppse)
    sc.add_Sensor(_ortho_cam((2.5, 0.0), 10.0))
    sc.add_BSDF(pt.DiffuseBSDF([rho, rho, rho]), "rho")
    sc.add_BSDF(pt.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    sc.add_Mesh(_quad_mesh([-10, -10, 0], [10, -10, 0], [10, 10, 0],
                           [-10, 10, 0], edges=False), None, "rho")
    hl = light_half
    sc.add_Mesh(_quad_mesh([-hl, -hl, 4], [hl, -hl, 4], [hl, hl, 4],
                           [-hl, hl, 4], flip=True, edges=False),
                None, "black", pt.AreaLight([L, L, L]))
    occluder = _quad_mesh([-1, -3, 2], [1, -3, 2], [1, 3, 2], [-1, 3, 2],
                          edges=True)
    sc.add_Mesh(occluder, None, "black")
    return sc, occluder


def _shadow_analytic(rho, L, light_half):
    """-(2/A_view) * int_{-1}^{1} (rho/pi) E(2, y) dy with point-light
    irradiance E(x, y) = L * A_l * 16 / (x^2 + y^2 + 16)^2."""
    a_l = (2 * light_half) ** 2
    y = np.linspace(-1, 1, 20001)
    e = L * a_l * 16.0 / (4.0 + y ** 2 + 16.0) ** 2
    integral = np.trapezoid(rho / np.pi * e, y)
    return -2.0 / 4.0 * integral


def test_shadow_scene_primal():
    """Shadow boundary at x=2: the left strip of the view is dark."""
    sc, _ = _shadow_scene(w=32, sppse=0)
    sc.configure()
    img = pt.PathTracer(1).renderC(sc, 0, seed=0).numpy().reshape(32, 32, 3)
    # look_at flips the camera x-axis: column 0 -> world x=1.5 (shadowed),
    # column 31 -> world x=3.5 (lit)
    lit = img[:, 26:, 0].mean()
    dark = img[:, :6, 0].mean()
    assert lit > 5.0 * max(dark, 1e-6)


def test_secondary_edge_gradient_analytic():
    rho, L, hl = 0.8, 200.0, 0.05
    sc, occluder = _shadow_scene(w=32, sppse=64, light_half=hl, rho=rho,
                                 L=L)
    sc.configure()
    g = _mean_tangent(sc, occluder, pt.PathTracer(1), range(6))
    expect = _shadow_analytic(rho, L, hl)
    assert expect < 0
    np.testing.assert_allclose(g, expect, rtol=0.15)


def test_secondary_edge_interior_alone_misses_gradient():
    sc, occluder = _shadow_scene(w=32, sppse=8)
    sc.opts.sppse = 0
    sc.configure()
    g = _mean_tangent(sc, occluder, pt.PathTracer(1), [0])
    expect = abs(_shadow_analytic(0.8, 200.0, 0.05))
    assert abs(g) < 0.2 * expect
