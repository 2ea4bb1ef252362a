"""Device time of the radix-sort kernels (``DeviceRadixSort*``, the
per-frame dedup's and the window's sorts) in the traced pass, ms a ping.
None where the profiler dropped kernel records."""


def read(r):
    us = r.trace.kernel_us("DeviceRadixSort")
    if not us or not r.trace.kernels_complete():
        return None
    return us / 1e3 / r.pings
