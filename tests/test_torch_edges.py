"""The primary-edge term of psdr_jit_tpu_torch against the JAX package's:
the edge topology, the silhouette tables, the edge samples and the
pullback of the derivative-only primary-edge image.

Both packages compile the same Cornell box (16x16, sppe 4, carried across
with interop.scene_to_arrays). The JAX package's edge adjoint rounds the
image cotangent to bf16 by default (``SPLAT_TRANSPOSE = "rows_bf16"``, a
TPU bandwidth measure the port does not carry); the comparison sets its
exact f32 transpose ``"rows"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from psdr_jit_tpu.core.sampler import Sampler as JSampler
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.sensor.sensor import sample_primary_edge as j_sample_pe
from psdr_jit_tpu_torch.core.sampler import Sampler
from psdr_jit_tpu_torch.integrator import base as tbase
from psdr_jit_tpu_torch.integrator.base import STREAM_PRIMARY
from psdr_jit_tpu_torch.sensor.sensor import sample_primary_edge
from psdr_jit_tpu_torch.shape.mesh import build_edge_list
from scenes import make_cbox

W, SPPE, SEED, DEPTH = 16, 4, 3, 2
# Screen-space endpoints: both packages project with a 4x4 matrix whose
# inverse they round in different orders (tests/test_torch_scene.py).
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def pair():
    jsc = make_cbox(width=W, height=W, spp=4, sppe=SPPE)
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc))
    return jsc, sc, sc.configure()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("mesh", range(8))
def test_build_edge_list_bitwise(pair, mesh):
    """Each cbox mesh's edge rows equal the JAX package's ``_edge_rows``
    (built by its native builder where it has one)."""
    jsc, sc, _ = pair
    ref = np.asarray(jsc.meshes[mesh]._edge_rows)
    np.testing.assert_array_equal(sc.meshes[mesh]._edge_rows, ref)
    np.testing.assert_array_equal(
        build_edge_list(jsc.meshes[mesh].face_indices), ref)


def test_build_edge_list_soup_bitwise():
    """A random mesh with boundary, shared and non-manifold edges, against
    the JAX package's builder."""
    from psdr_jit_tpu.shape.mesh import build_edge_list as j_build

    faces = np.random.default_rng(5).integers(0, 40, (300, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])].astype(np.int32)
    ref = j_build(faces)
    out = build_edge_list(faces)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert (out[:, 3] == -1).any() and (out[:, 3] >= 0).any()


def test_edges_disabled_builds_none(pair):
    jsc, _, _ = pair
    arrays = pt.scene_to_arrays(jsc)
    for i in range(len(jsc.meshes)):
        arrays[f"mesh.{i}.enable_edges"] = np.asarray(False)
    sc = pt.Scene.from_arrays(arrays)
    assert all(m.num_edges == 0 for m in sc.meshes)
    assert sc.configure().sensors[0].edge_info is None
    with pytest.raises(ValueError, match="no primary edges"):
        pt.PathTracer(1)._render_primary_edges(
            sc.data, sc.opts, 0, SEED, torch.zeros((W * W, 3)))


def test_primary_edge_tables(pair):
    """``build_primary_edges``: the silhouette classification (which edges
    keep sampling mass) is equal, the projected endpoints and lengths agree
    to f32 rounding, and so do the edge distribution's tables."""
    jsc, _, sd = pair
    ref = jax.lax.stop_gradient(jsc.data).sensors[0].edge_info
    out = sd.sensors[0].edge_info
    assert out.p0.shape == ref.p0.shape
    np.testing.assert_array_equal(_np(out.edge_length) > 0,
                                  _np(ref.edge_length) > 0)
    for name in ("p0", "p1", "edge_normal", "edge_length"):
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   _np(getattr(ref, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for name in ("pmf", "cdf"):
        np.testing.assert_allclose(_np(getattr(out.distrb, name)),
                                   _np(getattr(ref.distrb, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_sample_primary_edge(pair):
    """The edge samples of the primary stream: the same draws (bitwise),
    edges and pixels, and pdfs, screen velocities and ray pairs to f32
    rounding."""
    jsc, _, sd = pair
    jsd = jax.lax.stop_gradient(jsc.data)
    n = W * W * SPPE
    js = JSampler(jnp.uint32(SEED + STREAM_PRIMARY),
                  jnp.arange(n, dtype=jnp.uint32))
    ts = Sampler(SEED + STREAM_PRIMARY, torch.arange(n))
    ju, tu = js.next_1d(), ts.next_1d()
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    ref = j_sample_pe(jsd.sensors[0], ju)
    out = sample_primary_edge(sd.sensors[0], tu)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    assert (out.idx >= 0).float().mean() > 0.5
    np.testing.assert_allclose(_np(out.pdf), _np(ref.pdf), rtol=RTOL)
    np.testing.assert_allclose(_np(out.x_dot_n), _np(ref.x_dot_n),
                               rtol=RTOL, atol=ATOL)
    for side in ("ray_n", "ray_p"):
        for f in ("o", "d"):
            np.testing.assert_allclose(
                _np(getattr(getattr(out, side), f)),
                _np(getattr(getattr(ref, side), f)), rtol=RTOL, atol=ATOL,
                err_msg=f"{side}.{f}")


def test_primary_edge_pullback_matches_jax_vjp(pair, monkeypatch):
    """The port pulls an image cotangent through the derivative-only
    primary-edge pass into the projected edge endpoints; the JAX package
    does it with ``jax.vjp`` of ``_render_primary_edges``. Fed the JAX
    package's edge rays, the port's pair of radiances equals the JAX
    package's on every lane; its own edge rays differ from them in the
    last bit on about half the lanes (the two packages round the camera
    transform differently), and since every edge ray grazes a silhouette
    by construction, that flips a hit on 15-28 of these 1,024 lanes at
    depth 1-3 (measured). Those lanes move the endpoint cotangents by
    2.4e-3 to 4.0e-3 relative L1 (measured at depth 1-3), inside the
    step's gradient bound of 1e-2."""
    monkeypatch.setattr(jimage, "SPLAT_TRANSPOSE", "rows")
    jsc, sc, sd = pair
    g = np.random.default_rng(11).standard_normal((W * W, 3)).astype(
        np.float32)
    jsd = jax.lax.stop_gradient(jsc.data)
    jinteg = psdr.PathTracer(DEPTH)
    img, pull = jax.vjp(lambda s: jinteg._render_primary_edges(
        s, jsc.opts, 0, jnp.uint32(SEED)), jsd)
    assert not np.asarray(img).any()
    (sd_bar,) = pull(jnp.asarray(g))
    ref = sd_bar.sensors[0].edge_info

    info = sd.sensors[0].edge_info
    leaves = {k: getattr(info, k).detach().clone().requires_grad_()
              for k in ("p0", "p1")}
    sensor = dataclasses.replace(sd.sensors[0],
                                 edge_info=dataclasses.replace(info, **leaves))
    sd_leaf = dataclasses.replace(sd, sensors=(sensor,))
    monkeypatch.setattr(tbase, "TRAIN_CHUNK_LANES", 300)
    pt.PathTracer(DEPTH)._render_primary_edges(
        sd_leaf, sc.opts, 0, SEED, torch.from_numpy(g))
    for k, leaf in leaves.items():
        want = np.asarray(getattr(ref, k))
        got = leaf.grad.numpy()
        assert np.abs(want).sum() > 0, k
        rel = np.abs(got - want).sum() / np.abs(want).sum()
        assert rel < 1e-2, (k, rel)
