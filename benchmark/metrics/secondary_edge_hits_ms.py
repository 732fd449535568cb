"""secondary_edge_hits_ms (ms): the secondary-edge pass's closest hits
(``scene/scene.py SceneData.ray_intersect``: the kernel and the hit
rebuilt from its payload, three ray sets a chunk), the program span
``secondary_edge.hits`` on the device clock, a mean per entry call."""

import program_spans

program_spans.switch_on()


def read(trace):
    return program_spans.mean_ms(("secondary_edge.hits",), "device")
