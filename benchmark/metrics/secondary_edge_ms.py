"""secondary_edge_ms (ms): the secondary-edge estimator
(``integrator/edge.py``), the training step's ``render_secondary_edges``
(values and their pullback) and each chunk of renderD's
``secondary_edge_vals``, the mean per iteration over the traced window."""

from tracing import span_mean_ms

SITES = [("psdr_jit_tpu_torch.integrator.path",
          "PathTracer.render_secondary_edges", "secondary_edge", "call"),
         ("psdr_jit_tpu_torch.integrator.path",
          "PathTracer.secondary_edge_vals", "secondary_edge", "returns_fn")]


def read(trace):
    return span_mean_ms(trace, "secondary_edge")
