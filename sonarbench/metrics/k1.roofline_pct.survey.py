"""K1's share of its memory roofline over the traced pass: the least time
of the bytes its windows need (``roofline.k1_least_s`` from each
window's ``batch_n_bricks`` and ``batch_n_lanes``, not the padded
widths) over K1's device time (``bin_apply_kernel``), in percent of the
published 3.35 TB/s.  None where the trace holds no K1 or dropped kernel
records."""

from sonarbench import roofline


def read(r):
    us = r.trace.kernel_us("bin_apply_kernel")
    if not us or not r.trace.kernels_complete():
        return None
    least = roofline.k1_least_s(r.stats, r.knobs["window"])
    return 100.0 * least / (us / 1e6)
