"""K2 (the detached Li megakernel) of psdr_jit_tpu_torch against the JAX
package's megakernel run by the Pallas interpreter, in its single, pair and
stash modes.

Both get the same tables, camera rays, lanes, seed and first draw counter.
At depth 0 (emission only, no secondary rays) the radiance must be equal
bit for bit. With bounces the two differ only where an f32 rounding
difference flips a visibility test: the port writes the fused multiply-adds
that the JAX package's CPU backend contracts in the sweep and at the hit
points, but not every one it contracts elsewhere, so a grazing
self-intersection test at RAY_EPSILON still flips on a few lanes in a
thousand: relative L1 below 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
from psdr_jit_tpu_torch.core import warp
from psdr_jit_tpu_torch.ops import megakernel as mk
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

SEED = 5


@pytest.fixture(scope="module")
def setup():
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(
        make_cbox(width=32, height=32, spp=4)), device=CPU)
    sd = sc.configure()
    tables = mk.build_tables(sd)
    _, sampler, samples = interior_lane_setup(32, 32, 4, SEED,
                                              torch.arange(32 * 32))
    ray = sd.sensors[0].sample_primary_ray(samples)
    return sd, tables, sampler, ray


def _j(x):
    return jnp.asarray(x.numpy())


def _jax_li(tables, ray, active, lane, cnt0, depth, hide):
    return np.asarray(jmk.li_mega(
        *(jnp.asarray(t.numpy()) for t in tables),
        jnp.asarray(ray.o.numpy()), jnp.asarray(ray.d.numpy()),
        jnp.asarray(active.numpy()),
        jnp.asarray(lane.numpy().astype(np.uint32)), jnp.uint32(SEED),
        depth=depth, cnt0=cnt0, hide_emitters=hide, interpret=True))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_li_plain_matches_jax_megakernel(setup, depth):
    _, tables, sampler, ray = setup
    n = ray.o.shape[0]
    active = torch.ones(n, dtype=torch.bool)
    ref = _jax_li(tables, ray, active, sampler.lane, sampler.cnt, depth,
                  False)
    out = mk.li_mega(*tables, ray.o, ray.d, active, sampler.lane, SEED,
                     depth=depth, cnt0=sampler.cnt).numpy()
    assert out.shape == (n, 3) and np.isfinite(out).all()
    # an inactive lane returns 0 and leaves every other lane unchanged
    some = active.clone()
    some[::7] = False
    part = mk.li_mega(*tables, ray.o, ray.d, some, sampler.lane, SEED,
                      depth=depth, cnt0=sampler.cnt).numpy()
    assert (part[::7] == 0).all()
    np.testing.assert_array_equal(part[some.numpy()], out[some.numpy()])
    if depth == 0:
        np.testing.assert_array_equal(out, ref)
    else:
        rel = np.abs(out - ref).sum() / np.abs(ref).sum()
        assert rel < 1e-3, rel


def test_hide_emitters(setup):
    _, tables, sampler, ray = setup
    n = ray.o.shape[0]
    active = torch.ones(n, dtype=torch.bool)
    ref = _jax_li(tables, ray, active, sampler.lane, sampler.cnt, 0, True)
    out = mk.li_mega(*tables, ray.o, ray.d, active, sampler.lane, SEED,
                     depth=0, cnt0=sampler.cnt, hide_emitters=True)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert not out.any()


def test_pathtracer_li_advances_sampler(setup):
    """PathTracer.Li goes through li_mega (detached), li_interior
    (attached, ``diff=True``, for a caller that pulls back in reverse mode
    only, ``vjp_ok``: the training step) or the attached general Li
    (``diff=True`` otherwise, as renderD) and keeps the draw schedule: 2
    draws per depth, as the JAX package's Li. The attached Li shades the
    same paths: its radiance differs from the detached Li's only where the
    stash's bilinear bounce origins move a grazing hit, and the general
    Li's where its path-formulation hit points do (the bound of
    tests/test_torch_render.py between the two formulations)."""
    sd, tables, sampler, ray = setup
    s = pt.Sampler(SEED, sampler.lane)
    s.cnt = sampler.cnt
    active = torch.ones(ray.o.shape[0], dtype=torch.bool)
    li = pt.PathTracer(2).Li(sd, s, ray, active)
    assert s.cnt == sampler.cnt + 4
    ref = mk.li_mega_plain(*tables, ray.o, ray.d, active, sampler.lane,
                           SEED, 2, sampler.cnt)
    assert torch.equal(li, ref)
    s = pt.Sampler(SEED, sampler.lane)
    s.cnt = sampler.cnt
    att = pt.PathTracer(2).Li(sd, s, ray, active, diff=True, vjp_ok=True)
    assert s.cnt == sampler.cnt + 4
    assert att.shape == ref.shape and torch.isfinite(att).all()
    # measured: 1.2e-5 relative L1
    assert float((att - ref).abs().sum() / ref.abs().sum()) < 1e-4
    s = pt.Sampler(SEED, sampler.lane)
    s.cnt = sampler.cnt
    gen = pt.PathTracer(2).Li(sd, s, ray, active, diff=True)
    assert s.cnt == sampler.cnt + 4
    assert gen.shape == ref.shape and torch.isfinite(gen).all()
    # measured: 4.0e-4 relative L1
    assert float((gen - ref).abs().sum() / ref.abs().sum()) < 5e-3


def test_sincos_polynomials():
    """The bounce's sin/cos polynomials are accurate to ~1 ulp on
    [-pi/4, pi/4]."""
    phi = torch.linspace(-np.pi / 4, np.pi / 4, 100_001)
    s, c = warp.sincos_pio4(phi)
    ref = phi.double()
    np.testing.assert_allclose(s.double(), torch.sin(ref), atol=1.2e-7)
    np.testing.assert_allclose(c.double(), torch.cos(ref), atol=1.2e-7)


@pytest.mark.parametrize("depth", [1, 3])
def test_pair_plain_is_two_li_and_matches_jax(setup, depth):
    """Pair mode: Li(ray_n) - Li(ray_p) with ray_p drawing from
    cnt0 + 2 depth is two sequential single-mode calls, bit for bit, and
    the JAX package's li_mega_pair to f32 rounding."""
    _, tables, sampler, ray = setup
    n = ray.o.shape[0]
    active = torch.ones(n, dtype=torch.bool)
    active[::9] = False
    o2, d2 = ray.o.flip(0).contiguous(), ray.d.flip(0).contiguous()
    pair = mk.li_mega_pair(*tables, ray.o, ray.d, o2, d2, active,
                           sampler.lane, SEED, depth, sampler.cnt)
    li_n = mk.li_mega(*tables, ray.o, ray.d, active, sampler.lane, SEED,
                      depth, sampler.cnt)
    li_p = mk.li_mega(*tables, o2, d2, active, sampler.lane, SEED, depth,
                      sampler.cnt + 2 * depth)
    assert torch.equal(pair, li_n - li_p)
    ref = np.asarray(jmk.li_mega_pair(
        *(_j(t) for t in tables), _j(ray.o), _j(ray.d), _j(o2), _j(d2),
        _j(active), jnp.asarray(sampler.lane.numpy().astype(np.uint32)),
        jnp.uint32(SEED), depth=depth, cnt0=sampler.cnt, interpret=True))
    rel = np.abs(pair.numpy() - ref).sum() / np.abs(ref).sum()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("depth", [1, 3])
def test_stash_plain_matches_jax(setup, depth):
    """Stash mode: the (tri_id, u, v) of all 1 + 2 depth hits equal the JAX
    package's li_mega_stash except on lanes where a grazing test flipped
    (measured: at most 4 of 4096 lanes at depth 3), and its radiance equals
    the single mode's wherever the bilinear bounce origins changed no hit."""
    _, tables, sampler, ray = setup
    n = ray.o.shape[0]
    active = torch.ones(n, dtype=torch.bool)
    li, (ids, us, vs) = mk.li_mega_stash(*tables, ray.o, ray.d, active,
                                         sampler.lane, SEED, depth,
                                         sampler.cnt)
    assert ids.shape == us.shape == vs.shape == (1 + 2 * depth, n)
    assert ids.dtype == torch.int32
    ref_li, ref_hits = jmk.li_mega_stash(
        *(_j(t) for t in tables), _j(ray.o), _j(ray.d), _j(active),
        jnp.asarray(sampler.lane.numpy().astype(np.uint32)),
        jnp.uint32(SEED), depth=depth, cnt0=sampler.cnt, interpret=True)
    ref_ids, ref_u, ref_v = (np.stack([np.asarray(h[k]) for h in ref_hits])
                             for k in range(3))
    same = ids.numpy() == ref_ids
    lanes_off = (~same).any(0).sum()
    assert lanes_off <= 0.002 * n, lanes_off
    # the camera hit is the single mode's sweep: equal everywhere
    assert same[0].all()
    # barycentrics of the same hit: equal at the camera hit; the secondary
    # rays' directions, which the JAX package's CPU backend rounds with
    # other contractions (light sample, frame), move them by ulps (measured
    # at most 8e-6)
    np.testing.assert_array_equal(us.numpy()[0], ref_u[0])
    np.testing.assert_array_equal(vs.numpy()[0], ref_v[0])
    for a, b in ((us, ref_u), (vs, ref_v)):
        np.testing.assert_allclose(a.numpy()[same], b[same], atol=3e-5)
    rel = np.abs(li.numpy() - np.asarray(ref_li)).sum() / np.abs(
        np.asarray(ref_li)).sum()
    assert rel < 1e-4, rel
