"""Kernel launches a ping: the host's ``cudaLaunchKernel`` calls in the
traced pass over its pings (as ``scripts/torch_profile_bench.py`` counts
them)."""


def read(r):
    n = r.trace.launches()
    return n / r.pings if n else None
