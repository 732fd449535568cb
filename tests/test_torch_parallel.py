"""The pixel-sharded render and training step of psdr_jit_tpu_torch
(``parallel/``, ``torch.distributed``) on two gloo ranks on the CPU.

Two worker processes (``tests/torch_parallel_worker.py``, each with a
timeout) join a gloo group at a free local port and run, on the 16x16 box
at spp 4, sppe 4, sppse 4, ``PathTracer(1)``: ``render_sharded`` in kinds
C and D (D in forward mode along the light's translation),
``make_fused_train_step`` unguided and guided (each rank builds its own
guiding table; the step makes it rank 0's) and ``train_step_example``.
This process holds them against the unsharded port and the unguided step
against the JAX package's ``make_fused_train_step`` on two of the eight
CPU devices of ``tests/conftest.py``.

Bounds: the interior rows of every frame are the unsharded render's bit
for bit (the sampler is keyed on the global lane); the edge images, the
losses and the gradients differ only in the order of their float sums,
held at ``tests/test_multiprocess.py``'s bounds (loss ``rtol`` 1e-5,
gradients ``rtol`` 1e-4, with an ``atol`` of 1e-6 of the largest entry,
since the vertex offsets' entries of both signs cancel; measured: loss
1.1e-7, gradients at most 5.7e-8 rel L1). Against the JAX package's
sharded step, ``test_torch_secondary_edges.py``'s bounds for the box's
three-estimator step (loss 2e-4, image 1e-3, translation, reflectance
and radiance 1e-2, vertex offsets 0.15; measured 3.2e-5, 4.7e-4,
3.7e-5, 9.7e-3, 1.6e-5 and 1.6e-2: the reflectance's is
``test_torch_fused.py``'s unsharded 9.7e-3, from the grazing lanes XLA's
FMAs flip).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import train_setup
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu.parallel.mesh import make_device_mesh as j_mesh
from psdr_jit_tpu.parallel.shard import make_fused_train_step as j_step
from scenes import make_cbox
from torch_parallel_worker import DEPTH, GUIDE, SEED, tx_setter
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
HERE = os.path.dirname(os.path.abspath(__file__))
W, SPP, SPPE, SPPSE = 16, 4, 4, 4
WORKER_TIMEOUT = 300  # seconds; a hung collective fails the test
JAX_RTOL = {"tx": 1e-2, "dv": 0.15, "alb": 1e-2, "rad": 1e-2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _box():
    return pt.Scene.from_arrays(np.load(_box.path), device=CPU)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results (``torch.save``d dicts), rank order."""
    tmp = tmp_path_factory.mktemp("ranks")
    _box.path = str(tmp / "box.npz")
    np.savez(_box.path, **pt.scene_to_arrays(make_cbox(
        width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)))
    port = str(_free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(r), "2", port, _box.path, str(tmp / f"rank{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def _step(integ, sc, **kw):
    params, apply, loss_fn = train_setup(sc, seed=0)
    return integ.loss_and_grad(sc, params, apply, loss_fn, 0, SEED, **kw)


def _same_step(got, ref):
    loss, grads, img = got
    r_loss, r_grads, r_img = ref
    assert torch.equal(img, r_img)  # the step's image: interior rows
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    for k, g in r_grads.items():
        assert float(g.abs().sum()) > 0, k
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(g.abs().max()),
                                   err_msg=k)


def test_ranks_hold_the_same_results(ranks):
    """Every rank gets the whole frame, the summed loss and gradients."""
    a, b = ranks
    assert (a["rank"], b["rank"], a["size"]) == (0, 1, 2)
    for k in ("frame_C", "frame_D", "tangent_D"):
        assert torch.equal(a[k], b[k]), k
    for k in ("step", "step_guided", "example"):
        la, lb = a[k][0], b[k][0]
        assert torch.equal(la, lb), k
        for n, g in a[k][1].items():
            assert torch.equal(g, b[k][1][n]), (k, n)


def test_render_sharded_matches_unsharded(ranks):
    """``render_sharded`` C: the unsharded frame bit for bit. D: the
    primal bit for bit (the edge images are zero in value), the tangent
    along the light's translation to the order of the edge sums."""
    sc = _box()
    sc.configure()
    integ = pt.PathTracer(DEPTH)
    assert torch.equal(ranks[0]["frame_C"], integ.renderC(sc, 0, seed=SEED))
    tx0, put = tx_setter(sc)
    with fwAD.dual_level():
        put(fwAD.make_dual(tx0, torch.ones(())))
        primal, tangent = fwAD.unpack_dual(integ.renderD(sc, 0, seed=SEED))
        primal, tangent = primal.clone(), tangent.clone()
    put(tx0)
    assert torch.equal(ranks[0]["frame_D"], primal)
    assert float(tangent.abs().sum()) > 0
    np.testing.assert_allclose(ranks[0]["tangent_D"].numpy(),
                               tangent.numpy(), rtol=1e-4,
                               atol=1e-6 * float(tangent.abs().max()))


def test_fused_step_matches_unsharded(ranks):
    """``make_fused_train_step`` against ``loss_and_grad``."""
    _same_step(ranks[0]["step"], _step(pt.PathTracer(DEPTH), _box()))


def test_guiding_tables_equal_on_both_ranks(ranks):
    """Each rank built its own guiding table; the step made both rank 0's,
    bit for bit, and the guided step is the unsharded step guided by that
    table."""
    a, b = ranks

    def flat(t):
        return [t.distrb.pmf, t.distrb.cdf, t.distrb.alias_rows]

    for x, y in zip(flat(a["table"]), flat(b["table"])):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(flat(a["table"]), flat(a["table_own"])):
        assert (x is None and y is None) or torch.equal(x, y)
    assert a["table"].res == GUIDE[:3]
    _same_step(a["step_guided"],
               _step(pt.PathTracer(DEPTH), _box(), warp=a["table"]))


def test_train_step_example_matches_unsharded(ranks):
    """``train_step_example``: ``sum((renderD - target)^2)`` and its
    gradient along the light's translation, against the unsharded
    renderD's (``tests/test_multiprocess.py``'s bounds)."""
    sc = _box()
    sc.configure()
    integ = pt.PathTracer(DEPTH)
    target = integ.renderC(sc, 0, seed=9) * 0.8
    tx0, put = tx_setter(sc)
    tx = tx0.clone().requires_grad_()
    put(tx)
    loss = torch.square(integ.renderD(sc, 0, seed=9) - target).sum()
    (g,) = torch.autograd.grad(loss, tx)
    put(tx0)
    d_loss, d_grads = ranks[0]["example"]
    np.testing.assert_allclose(float(d_loss), float(loss.detach()), rtol=1e-5)
    assert float(g) != 0.0
    np.testing.assert_allclose(float(d_grads["tx"]), float(g), rtol=1e-4,
                               atol=1e-8)


def test_fused_step_matches_jax_sharded(ranks):
    """The port's sharded step against the JAX package's
    ``make_fused_train_step`` on two of the conftest's CPU devices, the
    same box, parameters and loss."""
    jsc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)
    jsc.configure()
    m0, m2 = jsc.meshes[0], jsc.meshes[2]
    base0 = jnp.asarray(m0.to_world_raw)
    verts = jnp.asarray(m2.vertex_positions_raw)
    tgt = jnp.asarray(np.random.default_rng(0).random(
        (W * W, 3)).astype(np.float32))

    def apply(p):
        m0.to_world_raw = base0.at[0, 3].add(p["tx"])
        m2.vertex_positions_raw = verts + p["dv"]
        jsc.bsdfs[1].reflectance.data = jnp.broadcast_to(
            p["alb"], jnp.shape(jsc.bsdfs[1].reflectance.data))
        jsc.emitters[0].radiance = p["rad"]

    p0 = {"tx": jnp.float32(0.0), "dv": jnp.zeros_like(verts),
          "alb": jnp.asarray(jsc.bsdfs[1].reflectance.data).reshape(-1)[:3],
          "rad": jnp.asarray(jsc.emitters[0].radiance)}
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        step = j_step(jsc, psdr.PathTracer(DEPTH), j_mesh(2), apply,
                      lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]),
                                                -1))
        j_loss, j_grads, j_img = step(p0, SEED)
        j_loss, j_img = float(j_loss), np.asarray(j_img)
        j_grads = {k: np.asarray(v) for k, v in j_grads.items()}
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old
    loss, grads, img = ranks[0]["step"]
    assert abs(float(loss) - j_loss) <= 2e-4 * abs(j_loss)
    assert _rel(img.numpy(), j_img) < 1e-3, _rel(img.numpy(), j_img)
    for k, j in j_grads.items():
        g = grads[k].numpy()
        assert g.shape == j.shape and np.abs(g).sum() > 0, k
        assert _rel(g, j) < JAX_RTOL[k], (k, _rel(g, j))

