"""K1, the closest hit for at most 512 triangles, on the CPU.

On the card K1 takes an ``active`` input (a dead lane is neither swept nor
walked and reports a miss) and runs, up to ``SWEEP_MAX_TRIS`` triangles,
K2's queued sweep of a staged table (``csrc/intersect.cu``), above it the
walk of ``csrc/bvh.cu`` on the tree split by surface area that
``bvh.build_sah_bvh`` builds (leaves of at most ``SAH_LEAF``). On the CPU
the routing runs K1's plain version, the unculled sweep. Here, at the
492-triangle gallery (``chip_smoke.K1_GALLERY``, the largest that K1
takes), with the JAX package fed the same arrays:

* the port's routed intersection with an active mask against the JAX
  package's ``ray_intersect_pallas`` (K1's Pallas kernel in the
  interpreter, as ``tests/test_intersect_pallas.py`` runs it) and
  ``ray_intersect_detached`` (its CPU route, the brute force): dead lanes
  miss, ids are equal except where two hits tie within f32 rounding (the
  JAX package keeps the later of equal hits in its visit order, the port
  the lowest id), and where the ids agree t and uv are the Pallas kernel's
  bit for bit and the brute force's to 1e-5 relative (t) and 1e-6 (uv), as
  XLA compiles the brute force's arithmetic its own way;
* the plain walk of K1's tree (``bvh.ray_intersect_bvh_plain``, the
  walk's plain model) against the unculled sweep, bit for bit, on the
  gallery's rays and on exact ties in two visit orders;
* at the Cornell box (32 triangles), the plain model of K1's sweep
  (``sweep_grouped_plain`` with runs of 2, ``compact``) against the
  unculled sweep, bit for bit, on the secondary-edge stand-ins and on exact
  ties.

The rays are the secondary-edge stand-ins of ``chip_smoke.edge_rays``
(43% dead) and ``chip_smoke.mixed_rays``. The kernel itself is held
against its plain version on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py`` ``[K1]`` and ``[K1-frame]``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from chip_smoke import (K1_GALLERY, SCENE_NPZ, edge_rays, gallery_arrays,
                        mixed_rays, swapped_children, tie_case)
from psdr_jit_tpu.core.types import Ray as JRay
from psdr_jit_tpu.ops.intersect import ray_intersect_detached as j_detached
from psdr_jit_tpu.ops.intersect_pallas import ray_intersect_pallas
from psdr_jit_tpu_torch.ops import bvh
from psdr_jit_tpu_torch.ops import intersect as ix
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card


@pytest.fixture(scope="module")
def gallery():
    """The 492-triangle gallery's triangles and rays, as numpy arrays:
    ``(p0, e1, e2, {name: (o, d, active)})``."""
    sd = pt.Scene.from_arrays(gallery_arrays(**K1_GALLERY),
                              device=CPU).configure()
    gen = torch.Generator().manual_seed(7)
    rays = {"edge": edge_rays(sd, 2048, gen, CPU),
            "mixed": mixed_rays(sd, 1024, gen, CPU)}
    tri = sd.tri
    return (*(x.numpy() for x in (tri.p0, tri.e1, tri.e2)),
            {k: tuple(x.numpy() for x in v) for k, v in rays.items()})


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_gallery_is_k1s_largest(gallery):
    p0 = gallery[0]
    assert p0.shape[0] == 492 and p0.shape[0] <= ix.K1_MAX_TRIS
    assert ix.walk_name(p0.shape[0]) == "K1"
    assert not ix.needs_tree(p0.shape[0], CPU)
    assert ix.needs_tree(p0.shape[0], torch.device("cuda"))


def test_edge_rays_layout(gallery):
    """The stand-in lays its rays out as the double-width call of
    ``edge.py``: (p, d) then (p, -d), a pair sharing its liveness, each p
    on a triangle's edge, about 43% of lanes dead."""
    p0, e1, e2, rays = gallery
    o, d, act = rays["edge"]
    q = o.shape[0] // 2
    assert np.array_equal(o[:q], o[q:]) and np.array_equal(d[:q], -d[q:])
    assert np.array_equal(act[:q], act[q:])
    assert abs(1.0 - act.mean() - 0.43) < 0.05
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    # each origin lies on the segment between two vertices of a triangle
    v = np.stack([p0, p0 + e1, p0 + e2], 1).astype(np.float64)
    a, b = v[:, :, None], v[:, None, :]
    ab = b - a
    s = np.einsum("fijk,nfijk->nfij", ab, o[:64, None, None, None] - a) / (
        np.einsum("fijk,fijk->fij", ab, ab) + 1e-30)
    near = a + np.clip(s, 0, 1)[..., None] * ab
    dist = np.linalg.norm(o[:64, None, None, None] - near, axis=-1)
    assert (dist.reshape(64, -1).min(1) < 1e-4).all()


@pytest.mark.parametrize("ref", ["detached", "pallas_interpret"])
@pytest.mark.parametrize("family", ["edge", "mixed"])
def test_routed_with_active_matches_jax(gallery, ref, family):
    p0, e1, e2, rays = gallery
    o, d, act = rays[family]
    out = ix.ray_intersect_detached(_t(p0), _t(e1), _t(e2),
                                    pt.Ray(_t(o), _t(d)), _t(act))
    jt = [jnp.asarray(x) for x in (p0, e1, e2)]
    if ref == "detached":
        want = j_detached(*jt, JRay(jnp.asarray(o), jnp.asarray(d)),
                          jnp.asarray(act))
    else:
        want = ray_intersect_pallas(*jt, jnp.asarray(o), jnp.asarray(d),
                                    active=jnp.asarray(act), interpret=True)
    w_id, w_valid, w_uv, w_t = (np.asarray(x) for x in want)
    o_id, o_valid, o_uv, o_t = (x.numpy() for x in out)
    assert not o_valid[~act].any() and (o_id[~act] == -1).all()
    assert o_valid.sum() > 0.4 * act.size
    w_valid = w_valid & act  # the port reports a dead lane as a miss
    w_id = np.where(w_valid, w_id, -1)
    assert np.array_equal(o_valid, w_valid)
    same = o_id == w_id
    assert same.mean() >= 0.999
    tie = o_valid & (np.abs(o_t - w_t) <= 1e-5 * np.abs(w_t))
    assert (same | tie).all(), "ids differ where the hits are no f32 tie"
    hit = same & o_valid
    if ref == "pallas_interpret":
        # the same hit test in the same f32 operations: the same bits
        assert np.array_equal(o_t[hit], w_t[hit])
        assert np.array_equal(o_uv[hit], w_uv[hit])
    else:
        # XLA compiles the brute force's arithmetic its own way: ulps
        np.testing.assert_allclose(o_t[hit], w_t[hit], rtol=1e-5)
        np.testing.assert_allclose(o_uv[hit], w_uv[hit], atol=1e-6)


@pytest.mark.parametrize("family", ["edge", "mixed"])
def test_plain_walk_of_k1_tree_equals_sweep(gallery, family):
    """The kernel's plain model, the walk of K1's tree, gives the unculled
    sweep's hits bit for bit, dead lanes included, and tests far fewer
    triangles a ray than the 492 the sweep tests."""
    p0, e1, e2, rays = gallery
    o, d, act = (_t(x) for x in rays[family])
    tree = ix.routing_tree(_t(p0), _t(e1), _t(e2))
    assert tree.depth <= bvh.STACK
    stats = {}
    walked = bvh.ray_intersect_bvh_plain(tree, o, d, act, stats)
    swept = ix.ray_intersect_brute(_t(p0), _t(e1), _t(e2), o, d, act)
    for x, y in zip(walked, swept):
        assert torch.equal(x, y)
    assert stats["tri_tests"] < 20 * int(act.sum())


def test_plain_walk_of_k1_tree_keeps_lowest_id_of_ties():
    """Exact ties at K1's size (``tie_case(496, 40)``): the walk of K1's
    tree keeps the lowest id of equal distances, as the sweep does, in the
    tree as built and with every node's children swapped."""
    p0, e1, e2, ro, rd, low = (_t(x) for x in tie_case(n_tri=496,
                                                         n_pairs=40))
    tree = ix.routing_tree(p0, e1, e2)
    swept = ix.ray_intersect_brute(p0, e1, e2, ro, rd)
    assert (swept[0] == low.to(torch.int32)).float().mean() > 0.5
    for t in (tree, swapped_children(tree)):
        for x, y in zip(bvh.ray_intersect_bvh_plain(t, ro, rd), swept):
            assert torch.equal(x, y)


def test_plain_model_of_k1_sweep_equals_sweep():
    """K1's sweep up to ``SWEEP_MAX_TRIS`` triangles queues each ray's own
    runs of 2 and keeps the least ``(t, id)`` of its tests: its plain model
    gives the unculled sweep's hits bit for bit at the Cornell box, dead
    lanes included, with fewer tests a ray than the box's 32 triangles,
    and keeps the lowest id of exact ties."""
    sd = pt.Scene.from_arrays(np.load(SCENE_NPZ), device=CPU).configure()
    tri = sd.tri
    assert tri.p0.shape[0] <= ix.SWEEP_MAX_TRIS
    assert not ix.needs_tree(tri.p0.shape[0], torch.device("cuda"))
    o, d, act = edge_rays(sd, 2048, torch.Generator().manual_seed(9), CPU)
    tab, _ = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
    stats = {}
    got = ix.sweep_grouped_plain(tab, o.unbind(-1), d.unbind(-1), 2, stats,
                                 live=act, compact=True)
    swept = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2, o, d, act)
    got = [torch.where(act, x, m) for x, m in zip(got, ix.miss_like(o[:, 0]))]
    assert torch.equal(got[1], swept[0]) and torch.equal(got[0], swept[3])
    assert torch.equal(torch.stack(got[2:], -1), swept[2])
    assert stats["tri_tests"] < 16 * stats["rays"]
    p0, e1, e2, ro, rd, low = (_t(x) for x in tie_case(n_tri=160,
                                                         n_pairs=16))
    tab, _ = ix.pack_triangles(p0, e1, e2)
    got = ix.sweep_grouped_plain(tab, ro.unbind(-1), rd.unbind(-1), 2,
                                 compact=True)
    swept = ix.ray_intersect_brute(p0, e1, e2, ro, rd)
    assert torch.equal(got[1], swept[0]) and torch.equal(got[0], swept[3])
    assert (swept[0] == low.to(torch.int32)).float().mean() > 0.5
