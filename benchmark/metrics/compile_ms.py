"""compile_ms (ms): the scene compile (``scene/scene.py``
``Scene.configure_data``), the mean per iteration over the traced window."""

from tracing import span_mean_ms

SITES = [("psdr_jit_tpu_torch.scene.scene", "Scene.configure_data",
          "compile", "call")]


def read(trace):
    return span_mean_ms(trace, "compile")
