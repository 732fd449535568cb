"""secondary_edge_pullback_ms (ms): the training step's pullback of the
image cotangent through each secondary-edge chunk's splat and values
(``integrator/base.py chunked_splat_pullback``), the program span
``secondary_edge.pullback`` on the device clock, a mean per step."""

import program_spans

program_spans.switch_on()


def read(trace):
    return program_spans.mean_ms(("secondary_edge.pullback",), "device")
