"""K1_roofline (%): K1's bound (``roofline.k1_bytes`` over every traced
launch of ``psdr_jit_tpu_torch::k1_sweep``, bytes alone) over its device
time (``sweep_kernel``), summed over the shapes profile."""

import re

from roofline import k1_bytes, share

KERNEL = re.compile(r"\bsweep_kernel\b")


def read(trace):
    return share(trace, "psdr_jit_tpu_torch::k1_sweep", KERNEL, k1_bytes)
