"""Device time of the records kernel (``box_words_kernel``: each batch's
dedup sort words from its pings and poses, the program's
``kernels/box_words.py``) in the traced pass, ms a ping.  None where it
never launched (a program without it, or a pass whose records took the
plain PyTorch chain) or where the profiler dropped kernel records."""


def read(r):
    us = r.trace.kernel_us("box_words_kernel")
    if not us or not r.trace.kernels_complete():
        return None
    return us / 1e3 / r.pings
