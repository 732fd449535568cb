"""The attached interior shade of psdr_jit_tpu_torch (``ops/shade_mega.py``:
the plain versions of K3 and of K4, its adjoint) against the JAX package's.

The comparison feeds both packages the same stashed hits, camera rays,
lanes and seed: the JAX side runs ``_li_attached``, the per-lane function
its shade kernels evaluate (K3) and differentiate in-kernel with
``jax.vjp`` (K4), here under XLA; the port runs ``li_attached_plain`` and
autograd. Away from flipped tests the two evaluate the same f32
expressions, so the radiance agrees to 1e-6 relative L1; every cotangent
table group agrees to 1e-4, since its cotangents are sums over lanes that
the two packages reorder (measured: at most 5.2e-5). The ray cotangents
agree to 1e-3 (measured: at most 5.2e-4): the JAX package's CPU backend
contracts the camera hit point ``o + t d`` into a fused multiply-add and
the port does not, and the secondary segments that start there subtract
two nearby points, which magnifies that last bit. ``li_interior`` as a whole (K2 stash, tables,
shade) is held against the JAX package's ``li_interior`` run by the
Pallas interpreter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from psdr_jit_tpu.core.sampler import pcg4d as j_pcg4d, _u32_to_unit_float
from psdr_jit_tpu.core.types import Ray as JRay
from psdr_jit_tpu.ops import shade_mega as jsm
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
from psdr_jit_tpu_torch.ops import megakernel as mk
from psdr_jit_tpu_torch.ops import shade_mega as sm
from psdr_jit_tpu_torch.scene.scene import tree_map
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

W, SPP, SEED = 16, 4, 7


@pytest.fixture(scope="module")
def setup():
    jsc = make_cbox(width=W, height=W, spp=SPP)
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sd = sc.configure()
    _, sampler, samples = interior_lane_setup(W, W, SPP, SEED,
                                              torch.arange(W * W))
    ray = sd.sensors[0].sample_primary_ray(samples)
    active = torch.ones(W * W * SPP, dtype=torch.bool)
    active[::11] = False
    return jsc, sd, sampler, ray, active


def _j(x):
    return jnp.asarray(x.detach().numpy())


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_li_attached(table, light, misc, hits, o, d, lane, active, depth,
                     cnt0, ct):
    """The JAX package's attached Li of the stashed hits and its vjp with
    respect to (table, light, misc, o, d)."""
    ids, us, vs = (np.asarray(h) for h in hits)
    lane_u = jnp.asarray(lane.numpy().astype(np.uint32))
    shape = lane_u.shape
    draws = []
    for c in range(2 * depth):
        v = j_pcg4d(lane_u, jnp.full(shape, cnt0 + c, jnp.uint32),
                    jnp.full(shape, SEED, jnp.uint32),
                    jnp.full(shape, jsm._SALT, jnp.uint32))
        draws.append(tuple(_u32_to_unit_float(x) for x in v))
    act = jnp.asarray(active.numpy())

    def f(tab, lt, mc, oo, dd):
        blocks = tuple(
            (tab[jnp.maximum(ids[k], 0)].T, jnp.asarray(ids[k], jnp.float32),
             jnp.asarray(us[k]), jnp.asarray(vs[k]))
            for k in range(ids.shape[0]))
        out = jsm._li_attached(blocks, lt, mc[None], tuple(oo.T),
                               tuple(dd.T), draws, act, depth, False)
        return jnp.stack(out, axis=-1)

    out, pull = jax.vjp(jax.jit(f), _j(table), _j(light), _j(misc), _j(o),
                        _j(d))
    return np.asarray(out), [np.asarray(g) for g in pull(jnp.asarray(ct))]


def test_attached_tables_match_jax(setup):
    jsc, sd, *_ = setup
    ref = jsm._attached_tables(jax.lax.stop_gradient(jsc.data))
    out = sm.attached_tables(sd)
    for name, a, b in zip(("table", "light", "misc"), out, ref):
        b = np.asarray(b).reshape(a.shape)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_li_attached_plain_and_autograd_match_jax(setup, depth):
    """Forward (the plain K3) and autograd (the plain K4) against the JAX
    package's ``_li_attached`` and its vjp, at depth 0-3."""
    _, sd, sampler, ray, active = setup
    tables = mk.build_tables(sd)
    _, hits = mk.li_mega_stash(*tables, ray.o, ray.d, active, sampler.lane,
                               SEED, depth, sampler.cnt)
    inputs = [t.detach().clone().requires_grad_()
              for t in (*sm.attached_tables(sd), ray.o, ray.d)]
    out = sm.li_attached_plain(*inputs[:3], *hits, inputs[3], inputs[4],
                               active, sampler.lane, SEED, depth,
                               sampler.cnt)
    assert out.shape == (W * W * SPP, 3)
    assert torch.isfinite(out).all() and not out[~active].any()
    ct = np.random.default_rng(depth).standard_normal(out.shape).astype(
        np.float32)
    out.backward(torch.from_numpy(ct))
    ref, ref_grads = _jax_li_attached(*inputs[:3], hits, inputs[3],
                                      inputs[4], sampler.lane, active,
                                      depth, sampler.cnt, ct)
    assert _rel(out.detach(), ref) < 1e-6
    for name, x, g in zip(("table", "light", "misc", "o", "d"), inputs,
                          ref_grads):
        got = np.zeros_like(g) if x.grad is None else x.grad.numpy()
        if not np.abs(g).any():
            assert not got.any(), name
            continue
        assert np.isfinite(got).all(), name
        bound = 1e-3 if name in ("o", "d") else 1e-4
        assert _rel(got, g) < bound, (name, _rel(got, g))


def test_li_attached_detaches_the_payload(setup):
    """The hit payload and the flag columns take no gradient (JAX
    ``_fields``): perturbing the flag columns' values, not their side of
    0.5, changes neither the radiance nor the cotangents."""
    _, sd, sampler, ray, active = setup
    tables = mk.build_tables(sd)
    _, hits = mk.li_mega_stash(*tables, ray.o, ray.d, active, sampler.lane,
                               SEED, 2, sampler.cnt)
    table, light, misc = (t.detach() for t in sm.attached_tables(sd))
    shifted = table.clone()
    for col in (sm.ROW_FNMASK, sm.ROW_ISEM):
        shifted[:, col] = torch.where(shifted[:, col] > 0.5, 0.9, 0.1)
    outs = []
    for tab in (table, shifted):
        tab = tab.clone().requires_grad_()
        out = sm.li_attached_plain(tab, light, misc, *hits, ray.o, ray.d,
                                   active, sampler.lane, SEED, 2, sampler.cnt)
        out.sum().backward()
        outs.append((out.detach(), tab.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for col in (sm.ROW_FNMASK, sm.ROW_ISEM):
        assert not outs[0][1][:, col].any()


def test_li_interior_matches_jax(setup):
    """``li_interior`` end to end (stash, attached tables, shade) against
    the JAX package's (Pallas interpreter), forward and the pullback into
    the scene's triangle, material and emitter tables, at depth 2. The
    stash's hits differ on the few lanes where a grazing test flips
    (tests/test_torch_megakernel.py), hence 1e-4 and 1e-3."""
    jsc, sd, sampler, ray, active = setup
    depth = 2
    ct = np.random.default_rng(3).standard_normal(
        (W * W * SPP, 3)).astype(np.float32)
    jsd = jax.lax.stop_gradient(jsc.data)

    def jf(s):
        return jsm.li_interior(
            s, JRay(_j(ray.o), _j(ray.d)), jnp.asarray(active.numpy()),
            jnp.asarray(sampler.lane.numpy().astype(np.uint32)),
            jnp.uint32(SEED), depth=depth, cnt0=sampler.cnt,
            interpret=True)

    ref, pull = jax.vjp(jf, jsd)
    (sd_bar,) = pull(jnp.asarray(ct))

    leaves = {}

    def leaf(t):
        if not t.is_floating_point():
            return t
        if id(t) not in leaves:
            leaves[id(t)] = t.detach().clone().requires_grad_()
        return leaves[id(t)]

    sd_leaf = tree_map(leaf, sd)
    out = sm.li_interior(sd_leaf, ray, active, sampler.lane, SEED, depth,
                         sampler.cnt)
    out.backward(torch.from_numpy(ct))
    assert _rel(out.detach(), ref) < 1e-4
    pairs = [(sd.tri.p0, sd_bar.tri.p0), (sd.tri.e1, sd_bar.tri.e1),
             (sd.tri.face_normal, sd_bar.tri.face_normal),
             (sd.tri.face_area, sd_bar.tri.face_area),
             (sd.emitters[0].radiance, sd_bar.emitters[0].radiance),
             (sd.bsdfs[1].reflectance.data,
              sd_bar.bsdfs[1].reflectance.data.reshape(-1)[:3])]
    for k, (orig, want) in enumerate(pairs):
        got = leaves[id(orig)].grad.numpy()
        assert np.abs(np.asarray(want)).sum() > 0, k
        assert _rel(got, want) < 1e-3, (k, _rel(got, want))
