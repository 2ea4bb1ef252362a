"""Times the host waited for the card in the traced pass: stream, device
and event synchronize calls and blocking copies.  A read to the host
through ``cudaMemcpyAsync`` shows as a copy and a stream synchronize and
counts once."""


def read(r):
    if not r.trace.launches():
        return None
    return float(r.trace.host_waits())
