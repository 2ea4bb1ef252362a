"""Device time of the operations launched inside the program's
``sonar3d.apply`` spans (each window's apply: the (brick, frame, offset)
sort, the table's lookups and inserts, K1 and the commit) in the traced
pass, charged by launch correlation (``sonarbench.spans``), ms a ping.
None where the trace cannot say."""

from sonarbench import spans


def read(r):
    s = spans.of(r.trace)
    if s is None:
        return None
    return s.device_us("apply") / 1e3 / r.pings
