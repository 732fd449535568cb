"""interior_hits_ms (ms): the interior estimator's closest hits through
``scene/scene.py SceneData.ray_intersect`` (the general Li's camera,
shadow and bounce rays; the megakernels trace theirs inside K2), the
program span ``interior.hits`` on the device clock, a mean per entry
call."""

import program_spans

program_spans.switch_on()


def read(trace):
    return program_spans.mean_ms(("interior.hits",), "device")
