"""compile_pullback_ms (ms): the training step's pullback through the
CPU scene compile (``integrator/fused.py loss_and_grad``, step 4: the
leaves' gradients through ``Scene.configure_data`` to the parameters),
the program span ``compile.pullback`` on the host clock, a mean per
step."""

import program_spans

program_spans.switch_on()


def read(trace):
    return program_spans.mean_ms(("compile.pullback",), "host")
