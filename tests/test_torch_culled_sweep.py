"""K2's culled sweeps in plain PyTorch (``ops/intersect.py``
``sweep_grouped_plain``) against the unculled sweep, and K2's sweep
recorder (``ops/megakernel.py`` ``Sweep``).

K2 culls with widened boxes of 16-triangle clusters and of runs of 2, 4 or
8 triangles inside them: for the whole warp, in ascending id against the
running hit, or per lane against no hit and keeping the least ``(t, id)``
(``compact``). Either way its hits must be the unculled sweep's bit for
bit; these tests hold the plain version of those sweeps to that on the
Cornell box's camera and bounce rays, axis-aligned rays whose origins lie
on the boxes' slab planes (where a slab test meets 0 * inf), rays grazing
the triangles' planes, and a case of exact ties (duplicated triangles), for
each run size. The culled sweep's hits are also held against the JAX
package's brute force. The kernel itself is checked on the card
(``tests/test_torch_kernels.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from chip_smoke import tie_case
from psdr_jit_tpu.ops.intersect import ray_intersect_brute as j_brute
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
from psdr_jit_tpu_torch.ops import intersect as ix
from psdr_jit_tpu_torch.ops import megakernel as mk
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "cbox_scene.npz")
GROUPS = [2, 4, 8]


@pytest.fixture(scope="module")
def cbox():
    """The Cornell box at 16x16 spp 4: its K2 tables, and the rays of every
    sweep of a depth-2 path (the sweep recorder of the plain K2)."""
    sc = pt.Scene.from_arrays(np.load(NPZ), device=CPU)
    sc.opts = pt.RenderOption(16, 16, 4, 0, 0)
    sd = sc.configure()
    tables = mk.build_tables(sd)
    _, sampler, samples = interior_lane_setup(16, 16, 4, 7,
                                              torch.arange(16 * 16))
    ray = sd.sensors[0].sample_primary_ray(samples)
    act = torch.ones(ray.o.shape[0], dtype=torch.bool)
    record = []
    mk.li_mega_plain(*tables, ray.o, ray.d, act, sampler.lane, 7, 2,
                     sampler.cnt, record=record)
    o = torch.cat([s.o for s in record])
    d = torch.cat([s.d for s in record])
    return tables[0], o, d


def _slab_plane_rays(tri, group, n, seed):
    """Axis-aligned rays whose origins lie on a face plane of a cluster's
    or a run's widened box."""
    rng = np.random.default_rng(seed)
    lo, hi = (torch.cat(x).numpy() for x in zip(
        ix.group_boxes(tri, ix.CLUSTER), ix.group_boxes(tri, group)))
    b = rng.integers(0, lo.shape[0], n)
    o = rng.uniform(lo[b], hi[b])
    ax = rng.integers(0, 3, n)
    o[np.arange(n), ax] = np.where(rng.integers(0, 2, n) == 0,
                                   lo[b, ax], hi[b, ax])
    d = np.zeros((n, 3))
    d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def _grazing_rays(tri, n, seed):
    """Rays nearly in a triangle's plane, passing close to it: origins off
    the plane by up to 1e-3 of the triangle's size, directions along the
    plane tilted by up to 1e-4."""
    rng = np.random.default_rng(seed)
    t = tri.numpy()
    j = rng.integers(0, t.shape[1], n)
    p0, e1, e2 = t[0:3, j].T, t[3:6, j].T, t[6:9, j].T
    nrm = np.cross(e1, e2)
    size = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(size, 1e-30)
    size = np.sqrt(size)
    b = rng.uniform(0, 1, (n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    target = p0 + e1 * b[:, :1] + e2 * b[:, 1:]
    along = e1 * rng.uniform(-1, 1, (n, 1)) + e2 * rng.uniform(-1, 1, (n, 1))
    along /= np.maximum(np.linalg.norm(along, axis=1, keepdims=True), 1e-30)
    d = along + nrm * rng.uniform(-1e-4, 1e-4, (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (target - d * size * rng.uniform(0.5, 2, (n, 1))
         + nrm * size * rng.uniform(-1e-3, 1e-3, (n, 1)))
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def _tie_rays():
    """``chip_smoke.tie_case`` cut to 180 triangles (40 duplicated pairs):
    its table and its rays, each aimed at a duplicated triangle."""
    p0, e1, e2, ro, rd, low = (torch.from_numpy(x) for x in
                               tie_case(n_tri=180, n_pairs=40, seed=3))
    tri, _ = ix.pack_triangles(p0, e1, e2)
    return tri, ro, rd, low


def _rays(kind, cbox, group):
    tri, o, d = cbox
    if kind == "slab_planes":
        o, d = _slab_plane_rays(tri, group, 4096, 1)
    elif kind == "grazing":
        o, d = _grazing_rays(tri, 4096, 2)
    elif kind == "ties":
        tri, o, d, _ = _tie_rays()
    return tri, o, d


@pytest.mark.parametrize("compact", [False, True], ids=["warp", "compact"])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("kind", ["camera_bounce", "slab_planes", "grazing",
                                  "ties"])
def test_culled_sweep_equals_unculled(cbox, kind, group, compact):
    tri, o, d = _rays(kind, cbox, group)
    want = ix.sweep_plain(tri, o.unbind(-1), d.unbind(-1))
    stats = {}
    got = ix.sweep_grouped_plain(tri, o.unbind(-1), d.unbind(-1), group,
                                 stats, compact=compact)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert (want[1] >= 0).any()
    # culling skipped work, and never more than an unculled sweep's
    assert stats["rays"] == o.shape[0]
    assert 0 < stats["tri_tests"] < o.shape[0] * tri.shape[1]
    if kind == "ties":
        _, _, _, low = _tie_rays()
        assert (got[1] == low.to(torch.int32)).float().mean() > 0.5


@pytest.mark.parametrize("group", GROUPS + [ix.CLUSTER])
def test_group_boxes_contain_triangle_boxes(cbox, group):
    for tri in (cbox[0], _tie_rays()[0]):
        p0, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
        v1, v2 = p0 + e1, p0 + e2
        lo, hi = ix.widen_boxes(torch.minimum(torch.minimum(p0, v1), v2),
                                torch.maximum(torch.maximum(p0, v1), v2))
        glo, ghi = ix.group_boxes(tri, group)
        assert glo.shape == (tri.shape[1] // group, 3)
        run = torch.arange(tri.shape[1]) // group
        assert (glo[run] <= lo).all() and (ghi[run] >= hi).all()
    clo, chi = ix.group_boxes(cbox[0], ix.CLUSTER)
    _, box = ix.pack_triangles(cbox[0][0:3].T, cbox[0][3:6].T,
                               cbox[0][6:9].T)
    wlo, whi = ix.widen_boxes(box[:3].T, box[3:].T)
    assert torch.equal(clo, wlo) and torch.equal(chi, whi)


def test_culled_sweep_matches_jax(cbox):
    """The culled sweeps' hits against the JAX package's brute force on the
    box's camera and bounce rays: ids equal but for f32 ties (the JAX CPU
    backend contracts multiply-adds differently), t within 1e-5."""
    tri, o, d = cbox
    ref = j_brute(*(jnp.asarray(tri[k:k + 3].T.numpy()) for k in (0, 3, 6)),
                  jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    r_id, r_t = np.asarray(ref[0]), np.asarray(ref[3])
    for compact in (False, True):
        t, ids, _, _ = ix.sweep_grouped_plain(tri, o.unbind(-1), d.unbind(-1),
                                              2, compact=compact)
        ids, t = ids.numpy(), t.numpy()
        same = ids == r_id
        assert same.mean() > 0.999
        tie = (ids >= 0) & (r_id >= 0) & (np.abs(t - r_t) <= 1e-5 * r_t)
        assert (same | tie).all()


def test_warp_counts(cbox):
    """The visit counts: without runs the culling is the clusters'; a
    warp's tests are at least its lanes' own and at most all of them."""
    tri, o, d = cbox
    n = o.shape[0]
    nc = tri.shape[1] // ix.CLUSTER
    for compact in (False, True):
        one, two = {}, {}
        ix.sweep_grouped_plain(tri, o.unbind(-1), d.unbind(-1), ix.CLUSTER,
                               one, compact=compact)
        ix.sweep_grouped_plain(tri, o.unbind(-1), d.unbind(-1), 2, two,
                               compact=compact)
        assert one["box_tests"] == n * nc
        assert two["box_tests"] > one["box_tests"]
        assert two["tri_tests"] < one["tri_tests"]
        for st in (one, two):
            assert st["tri_tests"] <= 32 * st["warp_tri_tests"] + 32 * 16
            assert st["warp_tri_tests"] <= -(-n // 32) * tri.shape[1]
    live = torch.zeros(n, dtype=torch.bool)
    live[::3] = True
    st = {}
    ix.sweep_grouped_plain(tri, o.unbind(-1), d.unbind(-1), 2, st, live)
    assert st["rays"] == int(live.sum())


@pytest.mark.parametrize("depth", [0, 2])
def test_sweep_recorder(cbox, depth):
    """The plain K2's recorder: one Sweep a sweep, in the stash's order, its
    hits the stash's, the camera sweep's lanes the active ones, and the
    outputs unchanged by recording."""
    sc = pt.Scene.from_arrays(np.load(NPZ), device=CPU)
    sc.opts = pt.RenderOption(8, 8, 2, 0, 0)
    sd = sc.configure()
    tables = mk.build_tables(sd)
    _, sampler, samples = interior_lane_setup(8, 8, 2, 3, torch.arange(64))
    ray = sd.sensors[0].sample_primary_ray(samples)
    act = torch.ones(ray.o.shape[0], dtype=torch.bool)
    act[::4] = False
    args = (*tables, ray.o, ray.d, act, sampler.lane, 3, depth, sampler.cnt)
    record = []
    li, (ids, us, vs) = mk.li_mega_stash_plain(*args, record=record)
    assert len(record) == 1 + 2 * depth
    assert torch.equal(torch.stack([s.id for s in record]), ids)
    assert torch.equal(torch.stack([s.u for s in record]), us)
    assert torch.equal(torch.stack([s.v for s in record]), vs)
    assert torch.equal(record[0].active, act)
    assert torch.equal(record[0].o, ray.o) and torch.equal(record[0].d, ray.d)
    assert all(not (s.active & ~act).any() for s in record)
    assert torch.equal(li, mk.li_mega_stash_plain(*args)[0])
    pair = []
    out = mk.li_mega_pair_plain(*tables, ray.o, ray.d, ray.o.flip(0),
                                ray.d.flip(0), act, sampler.lane, 3, depth,
                                sampler.cnt, record=pair)
    assert len(pair) == 2 * (1 + 2 * depth)
    assert torch.equal(out, mk.li_mega_pair_plain(
        *tables, ray.o, ray.d, ray.o.flip(0), ray.d.flip(0), act,
        sampler.lane, 3, depth, sampler.cnt))
