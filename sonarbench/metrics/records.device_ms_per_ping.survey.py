"""Device time of the operations launched inside the program's
``sonar3d.records`` spans (each group of windows' records: backprojection,
packing, the per-frame dedup and its sorts) in the traced pass, charged by
launch correlation (``sonarbench.spans``), ms a ping.  None where the
trace cannot say."""

from sonarbench import spans


def read(r):
    s = spans.of(r.trace)
    if s is None:
        return None
    return s.device_us("records") / 1e3 / r.pings
