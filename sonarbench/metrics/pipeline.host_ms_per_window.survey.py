"""Host time of the program's ``sonar3d.window`` spans (the dispatch of
each group of windows' records and applies, with any wait for the card
inside it) summed over the traced pass, over its windows
(ceil(pings / window)), ms a window.  None where the trace cannot say
(``sonarbench.spans``)."""

import math

from sonarbench import spans


def read(r):
    s = spans.of(r.trace)
    if s is None:
        return None
    return s.host_us("window") / 1e3 / math.ceil(r.pings / r.knobs["window"])
