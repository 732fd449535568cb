"""interior_ms (ms): the interior estimator, the training step's
``integrator/fused.py _interior_scan`` and renderD's and renderC's
``integrator/base.py _render_interior``, the mean per iteration over the
traced window."""

from tracing import span_mean_ms

SITES = [("psdr_jit_tpu_torch.integrator.fused", "_interior_scan",
          "interior", "call"),
         ("psdr_jit_tpu_torch.integrator.path", "PathTracer._render_interior",
          "interior", "call")]


def read(trace):
    return span_mean_ms(trace, "interior")
