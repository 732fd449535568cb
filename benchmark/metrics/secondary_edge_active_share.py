"""secondary_edge_active_share (%): the share of the lanes the
secondary-edge pass takes through its closest hits that are still live
(the program span ``secondary_edge.hits``'s counters ``active`` over
``rays``): the rest is glue spent on dead lanes, which bounds what
compacting the pass can save."""

import program_spans

program_spans.switch_on()


def read(trace):
    return program_spans.counter_share("secondary_edge.hits", "active",
                                       "rays")
