"""Time in the traced pass's window with no device operation running
while the host is in no ``sonar3d.window`` span: the card idle in the
pass's prologue (poses, boxes, the fresh map, the upload) and in its tail
after the last window (the stats read), ms a pass.  None where the trace
cannot say (``sonarbench.spans``)."""

from sonarbench import spans


def read(r):
    s = spans.of(r.trace)
    if s is None:
        return None
    return s.idle_us_outside("window") / 1e3
