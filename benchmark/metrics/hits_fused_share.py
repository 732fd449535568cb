"""hits_fused_share (%): the share of the closest hits' lanes whose hit
K7 rebuilt from the kernel's payload in one launch: the counter ``fused``
over the counter ``rays`` of every program span whose full name ends in
``hits`` (``interior.hits``, ``secondary_edge.hits``). 100 where every
rebuild ran on the card, 0 where the plain PyTorch rebuild ran; a program
without the counter gives nothing."""

import program_spans

program_spans.switch_on()


def read(trace):
    t = program_spans.totals()
    hits = [c for name, c in (t or {}).get("counters", {}).items()
            if name.rsplit(".", 1)[-1] == "hits" and "fused" in c]
    rays = sum(c.get("rays", 0) for c in hits)
    if not rays:
        return None
    return 100.0 * sum(c["fused"] for c in hits) / rays
