"""K7: the closest hit rebuilt from the closest-hit kernels' payload.

``SceneData.ray_intersect`` gets a detached payload ``(tri_id, valid,
uv)`` from K1, K5 or K6 and turns it into an ``Intersection`` in one of
two modes (its docstring): ``"path"``, the hit point from the payload's
barycentrics, and ``"solid"``, Moller-Trumbore again on the hit row and the
ray. On CPU tensors it does so in PyTorch (``SceneData._rebuild_plain``);
on CUDA tensors with one launch of K7 (``csrc/hit_rebuild.cu``), which
writes every field of the plain version, equal to it bit for bit.

Differentiation goes through :class:`_Rebuild`, a ``torch.autograd.Function``
(``custom_op.register_autograd`` has no forward mode, and forward-mode
renderD runs under ``torch.autograd.forward_ad``):

* its forward launches K7 (:func:`k7_op`);
* its ``jvp`` launches K7-jvp (:func:`k7_jvp_op`), the tangents of the
  fields along the tangents of the face table, the corner UVs and the
  rays;
* its ``backward`` launches K7-vjp (:func:`k7_vjp_op`), which recomputes
  each lane and writes the cotangents of its rays and sums those of its
  face's row (shared-memory partials up to
  ``gather.BINCOUNT_MAX_ROWS`` rows, global atomics above) and, where they
  carry a derivative, of its corner UVs (global atomics).

It saves the payload, the rays and the tables, nothing per field.

The tables (:func:`face_table`, ``SceneData.hit_rows``): a (R, 22) float
table of the differentiable rows (p0, e1, e2, n0, n1, n2, face normal,
face area), concatenated on each call so that its gradients and tangents
flow to the scene's tables; a (R, 5) int32 table (face-normal mask, mesh
id, the face's vertex ids in its mesh), built once a scene compile; the
(R, 6) corner UVs, built once a scene compile where they carry no
derivative (``uv_diff`` false), else the scene's own (attached) tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# the differentiable fields the kernels write, in their C order
FIELDS = ("t", "p", "n", "s", "tf", "sn", "wi", "J", "bc", "iuv", "dpdu",
          "dpdv")
COLS = 22   # the float table's columns
INTS = 5    # the int table's columns


def face_table(tri):
    """The (R, 22) float table of :class:`TriangleInfo` ``tri``'s
    differentiable rows, in the graph of its tables."""
    return torch.cat([tri.p0, tri.e1, tri.e2, tri.n0, tri.n1, tri.n2,
                      tri.face_normal, tri.face_area[:, None]], 1)


def _shapes(n: int, solid: bool, has_uv: bool):
    """The shapes of the 12 fields: ``bc`` in solid mode, ``iuv``, ``dpdu``
    and ``dpdv`` with UVs, else empty."""
    b, u = (n if solid else 0), (n if has_uv else 0)
    return ((n,), (n, 3), (n, 3), (n, 3), (n, 3), (n, 3), (n, 3), (n,),
            (b, 2), (u, 2), (u, 3), (u, 3))


def _fields(like, solid: bool, has_uv: bool):
    return [like.new_empty(s) for s in _shapes(like.shape[0], solid, has_uv)]


def _tangent_shapes(n: int, solid: bool, has_uv: bool, uv_diff: bool):
    """The shapes of K7-jvp's 12 tangents: the fields' (:func:`_shapes`),
    but empty for those :class:`_Rebuild` marks non-differentiable
    (:func:`_constant`)."""
    shapes = list(_shapes(n, solid, has_uv))
    for k in _constant(solid, uv_diff):
        shapes[k] = (0,) + shapes[k][1:]
    return tuple(shapes)


def _constant(solid: bool, uv_diff: bool):
    """The fields (their indices in :data:`FIELDS`) that the plain rebuild
    computes from no differentiable input: ``J = 1`` in solid mode, and in
    path mode the texture coordinates ``iuv`` where the corner UVs carry no
    derivative (``uv_diff`` false)."""
    if solid:
        return (7,)
    return () if uv_diff else (9,)


def _k7_outputs(ray_o, solid, has_uv, has_pv):
    n = ray_o.shape[0]
    ints = dict(dtype=torch.int32)
    return (*_fields(ray_o, solid, has_uv), ray_o.new_empty((n,), **ints),
            ray_o.new_empty((n if has_pv else 0, 3), **ints))


def _ptrs(tensors):
    """A C array of the tensors' data pointers, null for empty ones."""
    return (ctypes.c_void_p * len(tensors))(
        *(x.data_ptr() if x.numel() else None for x in tensors))


def _ptr(x):
    return x.data_ptr() if x.numel() else None


_ARGS = ("Tensor table, Tensor ints, Tensor uvt, Tensor tri_id, Tensor uv, "
         "Tensor ray_o, Tensor ray_d")


@_cuda.kernel_op("k7", f"({_ARGS}, bool solid, bool has_uv, bool has_pv) "
                 f"-> ({', '.join(['Tensor'] * 14)})", data_outputs=False)
def k7_op(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv,
          has_pv):
    """K7's launch, the operator behind :func:`rebuild_cuda` (which checks
    its inputs): the 12 fields of :data:`FIELDS`, the mesh ids and the
    face's vertex ids."""
    dev = ray_o.device
    out = _k7_outputs(ray_o, solid, has_uv, has_pv)
    n = ray_o.shape[0]
    if n == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_k7(
            table.data_ptr(), ints.data_ptr(), _ptr(uvt), table.shape[0],
            tri_id.data_ptr(), uv.data_ptr(), ray_o.data_ptr(), _ptr(ray_d),
            n, int(solid), int(has_uv), int(has_pv), _ptrs(out),
            _cuda.stream_of(dev))
    _cuda.check(err, "K7 launch")
    _cuda.LAUNCHES["K7"] += 1
    return out


@k7_op.register_fake
def _(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv, has_pv):
    return _k7_outputs(ray_o, solid, has_uv, has_pv)


@_cuda.kernel_op("k7_jvp", "(Tensor table, Tensor table_t, Tensor ints, "
                 "Tensor uvt, Tensor uvt_t, Tensor tri_id, Tensor uv, "
                 "Tensor ray_o, Tensor ray_o_t, Tensor ray_d, Tensor ray_d_t, "
                 "bool solid, bool has_uv, bool uv_diff) -> "
                 f"({', '.join(['Tensor'] * 12)})", data_outputs=False)
def k7_jvp_op(table, table_t, ints, uvt, uvt_t, tri_id, uv, ray_o, ray_o_t,
              ray_d, ray_d_t, solid, has_uv, uv_diff):
    """K7-jvp's launch, the operator behind :func:`rebuild_tangent_cuda`:
    the tangents of the 12 fields (:func:`_tangent_shapes`; an empty one is
    not written). An empty input tangent is zero."""
    dev = ray_o.device
    out = _jvp_outputs(ray_o, solid, has_uv, uv_diff)
    n = ray_o.shape[0]
    if n == 0:
        return tuple(out)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_k7_jvp(
            table.data_ptr(), _ptr(table_t), ints.data_ptr(), _ptr(uvt),
            _ptr(uvt_t), table.shape[0], tri_id.data_ptr(), uv.data_ptr(),
            ray_o.data_ptr(), _ptr(ray_o_t), _ptr(ray_d), _ptr(ray_d_t), n,
            int(solid), int(has_uv), _ptrs(out), _cuda.stream_of(dev))
    _cuda.check(err, "K7-jvp launch")
    _cuda.LAUNCHES["K7-jvp"] += 1
    return tuple(out)


@k7_jvp_op.register_fake
def _(table, table_t, ints, uvt, uvt_t, tri_id, uv, ray_o, ray_o_t, ray_d,
      ray_d_t, solid, has_uv, uv_diff):
    return tuple(_jvp_outputs(ray_o, solid, has_uv, uv_diff))


def _jvp_outputs(ray_o, solid, has_uv, uv_diff):
    return [ray_o.new_empty(s)
            for s in _tangent_shapes(ray_o.shape[0], solid, has_uv, uv_diff)]


def _k7_vjp_outputs(table, uvt, ray_o, solid, uv_diff):
    return (torch.zeros_like(table), torch.empty_like(ray_o),
            ray_o.new_empty((ray_o.shape[0] if solid else 0, 3)),
            torch.zeros_like(uvt) if uv_diff else uvt.new_empty((0, 6)))


@_cuda.kernel_op("k7_vjp", f"({_ARGS}, bool solid, bool has_uv, "
                 "bool uv_diff, Tensor[] cts) -> "
                 "(Tensor, Tensor, Tensor, Tensor)", data_outputs=False)
def k7_vjp_op(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv,
              uv_diff, cts):
    """K7-vjp's launch, the operator behind :func:`rebuild_adjoint_cuda`:
    ``(d_table (R, 22), d_o (N, 3), d_d (N, 3), empty in path mode, d_uvt
    (R, 6), empty without uv_diff)`` for the 12 fields' cotangents ``cts``
    (an empty one is zero)."""
    dev = ray_o.device
    d_table, d_o, d_d, d_uvt = _k7_vjp_outputs(table, uvt, ray_o, solid,
                                               uv_diff)
    n = ray_o.shape[0]
    if n == 0:
        return d_table, d_o, d_d, d_uvt
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_k7_vjp(
            table.data_ptr(), ints.data_ptr(), _ptr(uvt), table.shape[0],
            tri_id.data_ptr(), uv.data_ptr(), ray_o.data_ptr(), _ptr(ray_d),
            n, int(solid), int(has_uv), _ptrs(list(cts)), d_table.data_ptr(),
            d_o.data_ptr(), _ptr(d_d), _ptr(d_uvt), _cuda.stream_of(dev))
    _cuda.check(err, "K7-vjp launch")
    _cuda.LAUNCHES["K7-vjp"] += 1
    return d_table, d_o, d_d, d_uvt


@k7_vjp_op.register_fake
def _(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv, uv_diff,
      cts):
    return _k7_vjp_outputs(table, uvt, ray_o, solid, uv_diff)


def _check(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv):
    dev = ray_o.device
    _cuda.require(ray_o, "ray_o", torch.float32, (None, 3), dev)
    n = ray_o.shape[0]
    _cuda.require(table, "table", torch.float32, (None, COLS), dev)
    rows = table.shape[0]
    if not 0 < rows < 1 << 31:
        raise ValueError(f"K7 rebuilds hits on 1..2^31-1 faces, got {rows}")
    _cuda.require(ints, "ints", torch.int32, (rows, INTS), dev)
    _cuda.require(uvt, "uvt", torch.float32, (rows if has_uv else 0, 6),
                  dev)
    _cuda.require(tri_id, "tri_id", torch.int32, (n,), dev)
    _cuda.require(uv, "uv", torch.float32, (n, 2), dev)
    _cuda.require(ray_d, "ray_d", torch.float32, (n if solid else 0, 3), dev)


def _empty_or(x, like, shape):
    """``x`` contiguous, or an empty tensor where it is None."""
    if x is None:
        return like.new_empty((0,) + shape[1:])
    _cuda.require(x.contiguous(), "tangent", torch.float32, shape,
                  like.device)
    return x.contiguous()


def rebuild_cuda(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid: bool,
                 has_uv: bool, has_pv: bool):
    """Launch K7: the 12 fields of :data:`FIELDS` (``bc`` empty in path
    mode; ``iuv``, ``dpdu``, ``dpdv`` empty without UVs), the mesh ids
    (N,) and the face's vertex ids (N, 3) (empty without ``has_pv``), all
    int32 ids. ``ray_d`` is empty in path mode."""
    _check(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv)
    return k7_op(table, ints, uvt, tri_id, uv, ray_o, ray_d, bool(solid),
                 bool(has_uv), bool(has_pv))


def rebuild_tangent_cuda(table, table_t, ints, uvt, uvt_t, tri_id, uv,
                         ray_o, ray_o_t, ray_d, ray_d_t, solid: bool,
                         has_uv: bool, uv_diff: bool = False):
    """Launch K7-jvp: the tangents of :func:`rebuild_cuda`'s 12 fields
    along ``table_t`` (R, 22), ``uvt_t`` (R, 6), ``ray_o_t`` and
    ``ray_d_t`` (N, 3); a None tangent is zero. Those of :func:`_constant`'s
    fields (``J`` in solid mode; ``iuv`` in path mode unless ``uv_diff``,
    the corner UVs carrying a derivative) are empty."""
    _check(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv)
    return k7_jvp_op(table, _empty_or(table_t, table, table.shape), ints,
                     uvt, _empty_or(uvt_t if has_uv else None, uvt,
                                    uvt.shape), tri_id, uv, ray_o,
                     _empty_or(ray_o_t, ray_o, ray_o.shape), ray_d,
                     _empty_or(ray_d_t, ray_o, ray_d.shape), bool(solid),
                     bool(has_uv), bool(has_uv and uv_diff))


def rebuild_adjoint_cuda(table, ints, uvt, tri_id, uv, ray_o, ray_d,
                         solid: bool, has_uv: bool, cts,
                         uv_diff: bool = False):
    """Launch K7-vjp for the cotangents ``cts`` of :func:`rebuild_cuda`'s 12
    fields (None or empty: zero): ``(d_table (R, 22), d_o (N, 3), d_d,
    d_uvt)``, ``d_d`` (N, 3) in solid mode and empty in path mode,
    ``d_uvt`` (R, 6) with ``uv_diff`` and empty without. The row sums are
    float atomics, so their last bits vary from run to run."""
    _check(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv)
    shapes = _shapes(ray_o.shape[0], solid, has_uv)
    cts = [_empty_or(g if g is not None and g.numel() else None, ray_o, s)
           for g, s in zip(cts, shapes)]
    return k7_vjp_op(table, ints, uvt, tri_id, uv, ray_o, ray_d, bool(solid),
                     bool(has_uv), bool(has_uv and uv_diff), cts)


class _Rebuild(torch.autograd.Function):
    """K7 with K7-jvp as its forward-mode and K7-vjp as its reverse-mode
    derivative, differentiable in the face table, the rays and, with
    ``uv_diff``, the corner UVs."""

    @staticmethod
    def forward(table, ray_o, ray_d, uvt, ints, tri_id, uv, solid, has_uv,
                has_pv, uv_diff):
        return rebuild_cuda(table, ints, uvt, tri_id, uv, ray_o, ray_d,
                            solid, has_uv, has_pv)

    @staticmethod
    def setup_context(ctx, inputs, output):
        saved = inputs[:7]
        ctx.save_for_backward(*saved)
        ctx.save_for_forward(*saved)
        solid, has_uv, _, uv_diff = inputs[7:]
        ctx.flags = solid, has_uv, uv_diff
        # the ids, and the fields the plain rebuild computes from no
        # differentiable input
        ctx.mark_non_differentiable(*output[12:], *(
            output[k] for k in _constant(solid, uv_diff)))
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *cts):
        table, ray_o, ray_d, uvt, ints, tri_id, uv = ctx.saved_tensors
        solid, has_uv, uv_diff = ctx.flags
        d_table, d_o, d_d, d_uvt = rebuild_adjoint_cuda(
            table, ints, uvt, tri_id, uv, ray_o, ray_d, solid, has_uv,
            cts[:len(FIELDS)], uv_diff)
        return (d_table, d_o, d_d if solid else None,
                d_uvt if uv_diff else None) + (None,) * 7

    @staticmethod
    def jvp(ctx, table_t, ray_o_t, ray_d_t, uvt_t, *_):
        table, ray_o, ray_d, uvt, ints, tri_id, uv = ctx.saved_tensors
        solid, has_uv, uv_diff = ctx.flags
        out = list(rebuild_tangent_cuda(
            table, table_t, ints, uvt, uvt_t if uv_diff else None, tri_id,
            uv, ray_o, ray_o_t, ray_d, ray_d_t if solid else None, solid,
            has_uv, uv_diff))
        for k in _constant(solid, uv_diff):
            out[k] = None  # marked non-differentiable
        return (*out, None, None)


def rebuild(table, ints, uvt, tri_id, uv, ray_o, ray_d, solid: bool,
            has_uv: bool, has_pv: bool, uv_diff: bool = False):
    """The hit fields of :func:`rebuild_cuda`, differentiable (both modes of
    AD, and ``torch.func``) in ``table`` (R, 22), the rays (N, 3) and, with
    ``uv_diff``, the corner UVs ``uvt`` (R, 6); ``ray_d`` is an empty
    (0, 3) tensor in path mode."""
    return _Rebuild.apply(table, ray_o, ray_d, uvt, ints, tri_id, uv,
                          bool(solid), bool(has_uv), bool(has_pv),
                          bool(has_uv and uv_diff))
