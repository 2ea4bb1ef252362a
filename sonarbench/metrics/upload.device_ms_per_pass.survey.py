"""Device time of the operations launched inside the program's
``sonar3d.upload`` span (the pass's images and poses copied from host
memory to the card, and the poses' cast) in the traced pass, charged by
launch correlation (``sonarbench.spans``), ms a pass.  None where the
trace cannot say."""

from sonarbench import spans


def read(r):
    s = spans.of(r.trace)
    if s is None:
        return None
    return s.device_us("upload") / 1e3
