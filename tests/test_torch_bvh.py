"""The large-scene intersection of psdr_jit_tpu_torch on the CPU: the plain
versions of K5 (the unculled sweep, scanned in 512-triangle blocks) and of
K6 (the traversal of ``ops/bvh.py``'s binary tree, a frontier of (ray,
node) pairs expanded level by level), the tree, and the routing of
``ray_intersect_detached``.

Both plain versions are held against the JAX package's kernels run by the
Pallas interpreter, as ``tests/test_bvh.py`` runs them
(``ray_intersect_pallas`` on 1,200 triangles, which streams super-blocks,
and ``ray_intersect_bvh`` on 5,000): ids are equal except where two hits
tie within f32 rounding (the JAX kernels keep the later of equal hits in
their visit order, the port the lowest id), and t agrees to 1e-5
relative. Against the port's own unculled sweep they are equal bit for
bit, which shows that their culling changes no hit, and K6's tie rule
keeps the lowest id of equal distances in any visit order. The
cross-block and dead-lane cases mirror ``tests/test_bvh.py``.

The kernels themselves are held against these plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from chip_smoke import swapped_children, tie_case
from psdr_jit_tpu.ops.bvh import ray_intersect_bvh
from psdr_jit_tpu.ops.intersect_pallas import ray_intersect_pallas
from psdr_jit_tpu_torch.ops import bvh
from psdr_jit_tpu_torch.ops import intersect as ix
from tests.test_intersect import _random_scene

# the two routes past K1, by triangle count
ROUTES = {"K5": 1200, "K6": 5000}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _port(p0, e1, e2, ro, rd, active=None):
    """The routing entry on CPU tensors: the plain version of the route."""
    return ix.ray_intersect_detached(
        _t(p0), _t(e1), _t(e2), pt.Ray(_t(ro), _t(rd)),
        None if active is None else torch.from_numpy(active))


def _axis_rays(n, seed):
    """Rays along the coordinate axes from random origins: slab tests with
    infinite reciprocals."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3))
    d = np.zeros((n, 3))
    d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    return o.astype(np.float32), d.astype(np.float32)


def _on_plane_rays(p0, e1, e2, n, seed):
    """Axis-aligned rays with origins on the planes of 16-triangle cluster
    boxes: slab tests that meet 0 * inf."""
    _, box = ix.pack_triangles(_t(p0), _t(e1), _t(e2))
    bx = box.numpy()
    rng = np.random.default_rng(seed)
    c = rng.integers(0, bx.shape[1], n)
    o = rng.uniform(bx[:3, c].T, bx[3:, c].T)
    ax = rng.integers(0, 3, n)
    o[np.arange(n), ax] = bx[ax + 3 * rng.integers(0, 2, n), c]
    d = np.zeros((n, 3))
    d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("route", ["K5", "K6"])
def test_plain_matches_jax_kernel(route):
    """The route's plain version against the JAX kernel it replaces."""
    p0, e1, e2, ro, rd = _random_scene(n_tri=ROUTES[route], n_ray=700,
                                       seed=20)
    args = [jnp.asarray(x) for x in (p0, e1, e2, ro, rd)]
    if route == "K5":
        ref = ray_intersect_pallas(*args, interpret=True)
    else:
        ref = ray_intersect_bvh(*args, interpret=True)
    r_id, r_t = np.asarray(ref[0]), np.asarray(ref[3])
    o_id, _, _, o_t = (x.numpy() for x in _port(p0, e1, e2, ro, rd))
    assert (o_id >= 0).mean() > 0.3
    same = o_id == r_id
    tie = (o_id >= 0) & (r_id >= 0) & (np.abs(o_t - r_t)
                                       <= 1e-5 * np.abs(r_t))
    assert same.mean() >= 0.99 and (same | tie).all()
    hit = same & (o_id >= 0)
    np.testing.assert_allclose(o_t[hit], r_t[hit], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref[1]), o_id >= 0)


@pytest.mark.parametrize("route", ["K5", "K6"])
@pytest.mark.parametrize("rays", ["random", "on_plane", "axis"])
def test_plain_equals_unculled_sweep(route, rays):
    """Culling changes no hit: the route's plain version equals the
    unculled sweep bit for bit, including rays whose slab tests are NaN
    (on a box plane) or meet infinite reciprocals (along an axis)."""
    p0, e1, e2, ro, rd = _random_scene(n_tri=ROUTES[route], n_ray=1500,
                                       seed=31)
    if rays == "on_plane":
        ro, rd = _on_plane_rays(p0, e1, e2, 1500, 32)
    elif rays == "axis":
        ro, rd = _axis_rays(1500, 35)
    out = _port(p0, e1, e2, ro, rd)
    tri, _ = ix.pack_triangles(_t(p0), _t(e1), _t(e2))
    t, ids, u, v = ix.sweep_plain(tri, _t(ro).unbind(-1), _t(rd).unbind(-1))
    for a, b in zip(out, (ids, ids >= 0, torch.stack([u, v], -1), t)):
        assert torch.equal(a, b)
    if route == "K6":
        h = bvh.build_bvh(_t(p0), _t(e1), _t(e2))
        stats = {}
        again = bvh.ray_intersect_bvh_plain(h, _t(ro), _t(rd), stats=stats)
        assert all(torch.equal(a, b) for a, b in zip(again, out))
        assert 0 < stats["tri_tests"] < ro.shape[0] * h.tri.shape[1]
        assert stats["node_visits"] > 0


def test_blocked_sweep_equals_one_block(monkeypatch):
    """The plain sweep's 512-triangle blocks and ray chunks change no bit."""
    p0, e1, e2, ro, rd = _random_scene(n_tri=1100, n_ray=900, seed=33)
    tri, _ = ix.pack_triangles(_t(p0), _t(e1), _t(e2))
    o, d = _t(ro).unbind(-1), _t(rd).unbind(-1)
    blocked = ix.sweep_plain(tri, o, d)
    monkeypatch.setattr(ix, "PLAIN_TRI_BLOCK", 1 << 20)
    monkeypatch.setattr(ix, "PLAIN_RAY_CHUNK", 128)
    for a, b in zip(blocked, ix.sweep_plain(tri, o, d)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["K5", "K6"])
def test_cross_block_closest_hit(route):
    """The closest hit wins across blocks, in both directions of id order
    (tests/test_bvh.py test_bvh_cross_block_closest_hit)."""
    n_tri = ROUTES[route]
    p0 = np.zeros((n_tri, 3), np.float32)
    e1 = np.tile(np.float32([[2.0, 0, 0]]), (n_tri, 1))
    e2 = np.tile(np.float32([[0, 2.0, 0]]), (n_tri, 1))
    for j in range(n_tri):
        z = 10.0 + j * 0.01 if j < 512 else 5.0 + (j - 512) * 0.0001
        p0[j] = (-1.0, -1.0, z)
    p0[700, 2] = 0.5  # in the second block, the nearest
    ro = np.zeros((4, 3), np.float32)
    ro[2] = (0.0, 0.0, 9.0)  # past every second-block triangle
    rd = np.tile(np.float32([[0.0, 0.0, 1.0]]), (4, 1))
    tri_id, valid, _, t = (x.numpy() for x in _port(p0, e1, e2, ro, rd))
    assert tri_id[0] == 700 and abs(t[0] - 0.5) < 1e-5
    assert tri_id[2] == 0 and abs(t[2] - 1.0) < 1e-5
    assert valid.all()


@pytest.mark.parametrize("route", ["K5", "K6"])
def test_dead_lanes(route):
    """Inactive and non-finite lanes report a miss, untraced; live lanes
    are those of the all-active call (test_bvh_dead_lane_parking)."""
    p0, e1, e2, ro, rd = _random_scene(n_tri=ROUTES[route], n_ray=512,
                                       seed=23)
    live = np.random.default_rng(24).uniform(size=512) < 0.4
    ro_nan = ro.copy()
    ro_nan[::9] = np.nan
    full = _port(p0, e1, e2, ro, rd)
    part = _port(p0, e1, e2, ro_nan, rd, live)
    keep = live.copy()
    keep[::9] = False
    assert not part[1][~keep].any() and (part[0][~keep] == -1).all()
    for a, b in zip(full, part):
        assert torch.equal(a[keep], b[keep])
    assert part[1][keep].any()


@pytest.mark.parametrize("n_tri", [3, 1300])
def test_bvh_tables(n_tri):
    """The tree: each triangle in exactly one leaf of at most LEAF
    consecutive ids, every stored box containing its children's boxes and
    equal to the union of its triangles' widened boxes, the depth that of
    a midpoint split, and the triangle rows p0, e1, e2."""
    p0, e1, e2, _, _ = _random_scene(n_tri=n_tri, n_ray=1, seed=34)
    h = bvh.build_bvh(_t(p0), _t(e1), _t(e2))
    n_leaves = -(-n_tri // bvh.LEAF)
    assert h.node.shape == (n_leaves - 1, 16)
    assert h.depth == int(np.ceil(np.log2(n_leaves)))
    assert torch.equal(h.tri, torch.cat([_t(p0), _t(e1), _t(e2)], 1).T)
    assert not h.tri4[:, 9:].any()
    v0, v1, v2 = _t(p0), _t(p0) + _t(e1), _t(p0) + _t(e2)
    tlo, thi = ix.widen_boxes(torch.minimum(torch.minimum(v0, v1), v2),
                              torch.maximum(torch.maximum(v0, v1), v2))
    seen = torch.zeros(n_tri, dtype=torch.int64)

    def walk(entry):
        """Check the subtree of a stored child entry; returns its ids."""
        lo, hi = entry[0:3], entry[4:7]
        a, b = (int(x) for x in entry.view(torch.int32)[[3, 7]])
        if b < 0:
            assert 1 <= -b <= bvh.LEAF and a % bvh.LEAF == 0
            ids = torch.arange(a, a - b)
        else:
            assert b == 0
            row = h.node[a]
            for k in (0, 8):
                assert (lo <= row[k:k + 3]).all()
                assert (hi >= row[k + 4:k + 7]).all()
            ids = torch.cat([walk(row[0:8]), walk(row[8:16])])
        assert torch.equal(lo, tlo[ids].amin(0))
        assert torch.equal(hi, thi[ids].amax(0))
        return ids

    ids = walk(h.root)
    seen.index_add_(0, ids, torch.ones_like(ids))
    assert (seen == 1).all()


def test_ties_go_to_lowest_id_in_any_visit_order():
    """Duplicated triangles, hit at equal t from rays aimed at them
    (``chip_smoke.tie_case``): the lowest id of each pair wins, as in the
    unculled sweep, in the tree as built and with the two children of
    every node swapped."""
    p0, e1, e2, ro, rd, low = tie_case()
    h = bvh.build_bvh(_t(p0), _t(e1), _t(e2))
    brute = ix.ray_intersect_brute(_t(p0), _t(e1), _t(e2), _t(ro), _t(rd))
    on_low = brute[0].numpy() == low
    assert on_low.mean() > 0.5
    for tree in (h, swapped_children(h)):
        stats = {}
        out = bvh.ray_intersect_bvh_plain(tree, _t(ro), _t(rd), stats=stats)
        for a, b in zip(out, brute):
            assert torch.equal(a, b)
        assert stats["tri_tests"] < 5000 * ro.shape[0] // 10
