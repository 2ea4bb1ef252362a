"""The union of kernel intervals over the traced pass's own window, in
percent.  None where the trace holds fewer kernel events than launches."""

from sonarbench import trace


def read(r):
    if not r.trace.launches():
        return None
    return trace.busy_share_pct(r.trace)
