"""Replays in the traced pass: its ``sonar3d.scan`` spans less one (each
scan after the first replays from a failed window once a stale plan is
dropped, a budget grows or the table grows).  None where the trace cannot
say (``sonarbench.spans``)."""

from sonarbench import spans


def read(r):
    s = spans.of(r.trace)
    scans = 0 if s is None else len(s.named("scan"))
    return float(scans - 1) if scans else None
