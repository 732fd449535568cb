"""entry_self_ms (ms): the self time of the program's entry span, the
training step's ``step`` (``integrator/fused.py loss_and_grad``) or a
render's ``render`` (``integrator/base.py renderC``, ``renderD``), on the
device clock: the entry's time less its layers' (``compile``,
``interior``, ``primary_edge``, ``secondary_edge``,
``compile.pullback``), a mean per entry call."""

import program_spans

program_spans.switch_on()


def read(trace):
    return program_spans.mean_ms(("step", "render"), "self")
