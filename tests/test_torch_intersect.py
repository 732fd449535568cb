"""K1 (closest hit) of psdr_jit_tpu_torch against the JAX package.

On the CPU the port's entry runs its plain version, ray_intersect_brute;
it is held against the JAX brute force and the JAX Pallas kernel run by
the Pallas interpreter. Ids may differ only at f32 ties (two triangles hit
at the same distance, e.g. across a shared edge): the JAX package's CPU
backend contracts multiply-adds into FMAs and the port does not.

Axis-aligned rays whose origin lies on a cluster's box plane are the case
where a per-ray slab test meets 0 * inf. Those of them that lie in a
triangle's own plane are degenerate (|a| ~ 0, any "hit" is rounding) and
are only checked for a well-formed payload.

The kernel itself is checked on the card: tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from psdr_jit_tpu.integrator.base import interior_lane_setup as j_lane_setup
from psdr_jit_tpu.ops.intersect import ray_intersect_brute as j_brute
from psdr_jit_tpu.ops.intersect_pallas import ray_intersect_pallas
from psdr_jit_tpu_torch.ops import intersect as ix
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card


@pytest.fixture(scope="module")
def scenes():
    jsc = make_cbox(width=32, height=32, spp=4)
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sc.configure()
    return jsc, sc


def _rays(sd, jd):
    """Camera rays, random rays from inside the box, and axis-aligned rays
    on cluster planes (with a mask of the in-plane ones)."""
    rng = np.random.default_rng(0)
    _, _, samples = j_lane_setup(32, 32, 4, jnp.uint32(3),
                                 jnp.arange(32 * 32, dtype=jnp.int32))
    cam = jd.sensors[0].sample_primary_ray(samples, diff=False)
    ro = rng.uniform(np.asarray(jd.lower), np.asarray(jd.upper), (2048, 3))
    rd = rng.normal(size=(2048, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    _, box = ix.pack_triangles(sd.tri.p0, sd.tri.e1, sd.tri.e2)
    bx = box.numpy()
    n = 4096
    c = rng.integers(0, bx.shape[1], n)
    po = rng.uniform(bx[:3, c].T, bx[3:, c].T)
    ax = rng.integers(0, 3, n)
    po[np.arange(n), ax] = bx[ax + 3 * rng.integers(0, 2, n), c]
    pd = np.zeros((n, 3))
    pd[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    general = (np.concatenate([np.asarray(cam.o).reshape(-1, 3), ro]),
               np.concatenate([np.asarray(cam.d).reshape(-1, 3), rd]))
    fn, p0 = sd.tri.face_normal.numpy(), sd.tri.p0.numpy()
    in_plane = ((np.abs(pd @ fn.T) < 1e-6)
                & (np.abs(np.einsum("fk,nfk->nf", fn, po[:, None] - p0))
                   < 1e-3)).any(1)
    f32 = np.float32
    return ((general[0].astype(f32), general[1].astype(f32)),
            (po.astype(f32), pd.astype(f32)), in_plane)


def _check_against(ref, out, keep, min_match):
    r_id, r_t = (np.asarray(x) for x in (ref[0], ref[3]))
    o_id, o_t = out[0].numpy(), out[3].numpy()
    r_id, r_t, o_id, o_t = r_id[keep], r_t[keep], o_id[keep], o_t[keep]
    same = o_id == r_id
    assert same.mean() >= min_match, same.mean()
    tie = ((o_id >= 0) & (r_id >= 0)
           & (np.abs(o_t - r_t) <= 1e-5 * np.abs(r_t)))
    assert (same | tie).all(), "ids differ where the hits are no f32 tie"
    hit = same & (o_id >= 0)
    np.testing.assert_allclose(o_t[hit], r_t[hit], rtol=1e-5)
    np.testing.assert_array_equal(o_t[~(o_id >= 0)], np.float32(1e30))


@pytest.mark.parametrize("ref", ["brute", "pallas_interpret"])
def test_k1_plain_matches_jax(scenes, ref):
    jsc, sc = scenes
    jd, sd = jsc.data, sc.data
    (go, gd), (po, pd), in_plane = _rays(sd, jd)

    def jax_hits(o, d):
        args = (jd.tri.p0, jd.tri.e1, jd.tri.e2, jnp.asarray(o),
                jnp.asarray(d))
        if ref == "brute":
            return j_brute(*args)
        return ray_intersect_pallas(*args, interpret=True)

    def port_hits(o, d):
        return ix.ray_intersect_detached(
            sd.tri.p0, sd.tri.e1, sd.tri.e2,
            pt.Ray(torch.from_numpy(o), torch.from_numpy(d)))

    _check_against(jax_hits(go, gd), port_hits(go, gd),
                   np.ones(go.shape[0], bool), 0.999)
    out = port_hits(po, pd)
    _check_against(jax_hits(po, pd), out, ~in_plane, 0.99)
    assert np.isfinite(out[2].numpy()).all() and np.isfinite(out[3].numpy()).all()


def test_brute_is_dispatch_on_cpu(scenes):
    _, sc = scenes
    sd = sc.data
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(0, 550, (500, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.randn(500, 3), dim=-1)
    a = ix.ray_intersect_brute(sd.tri.p0, sd.tri.e1, sd.tri.e2, o, d)
    b = ix.ray_intersect_detached(sd.tri.p0, sd.tri.e1, sd.tri.e2,
                                  pt.Ray(o, d))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_detached_masks_nonfinite_and_inactive(scenes):
    _, sc = scenes
    sd = sc.data
    o = torch.tensor([[278.0, 273.0, -800.0]] * 4)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [np.nan, 0.0, 1.0],
                      [0.0, 0.0, 1.0]])
    active = torch.tensor([True, False, True, True])
    o[3, 0] = np.inf
    tri_id, valid, uv, t = ix.ray_intersect_detached(
        sd.tri.p0, sd.tri.e1, sd.tri.e2, pt.Ray(o, d), active)
    assert valid.tolist() == [True, False, False, False]
    assert tri_id[0] >= 0 and (tri_id[1:] == -1).all()
    assert uv.shape == (4, 2) and torch.isfinite(t).all()


def test_unit_ray_intersect_matches_jax(scenes):
    """Scene.unit_ray_intersect (path formulation) against the JAX one."""
    jsc, sc = scenes
    rng = np.random.default_rng(2)
    o = np.tile(np.float32([[278.0, 273.0, -800.0]]), (1000, 1))
    tgt = rng.uniform([0, 0, 0], [556, 548.8, 559.2], (1000, 3))
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    ref = jsc.unit_ray_intersect(jnp.asarray(o), jnp.asarray(d))
    out = sc.unit_ray_intersect(o, d)
    same = out.tri_id.numpy() == np.asarray(ref.tri_id)
    assert same.mean() >= 0.999
    hit = same & out.valid.numpy()
    assert hit.mean() > 0.9
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.mesh_id.numpy()[hit],
                                  np.asarray(ref.mesh_id)[hit])
    for name in ("t", "p", "n", "wi", "bc"):
        np.testing.assert_allclose(getattr(out, name).numpy()[hit],
                                   np.asarray(getattr(ref, name))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out.sh_frame.n.numpy()[hit],
                               np.asarray(ref.sh_frame.n)[hit], atol=1e-5)
