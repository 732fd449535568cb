"""primary_edge_ms (ms): the primary-edge estimator, the training step's
``_render_primary_edges`` (values and their pullback) and each chunk of
renderD's ``_primary_edge_vals``, the mean per iteration over the traced
window."""

from tracing import span_mean_ms

SITES = [("psdr_jit_tpu_torch.integrator.path",
          "PathTracer._render_primary_edges", "primary_edge", "call"),
         ("psdr_jit_tpu_torch.integrator.path",
          "PathTracer._primary_edge_vals", "primary_edge", "returns_fn")]


def read(trace):
    return span_mean_ms(trace, "primary_edge")
