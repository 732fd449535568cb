"""K2_roofline (%): K2's bound (``roofline.k2_bytes`` over every traced
launch of ``psdr_jit_tpu_torch::k2``, bytes alone) over its device time
(``li_mega_kernel``, all three modes), summed over the shapes profile."""

import re

from roofline import k2_bytes, share

KERNEL = re.compile(r"\bli_mega_kernel\b")


def read(trace):
    return share(trace, "psdr_jit_tpu_torch::k2", KERNEL, k2_bytes)
