"""Peak device memory over the measured window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
MiB.  None off the card."""


def read(r):
    if r.peak_bytes is None:
        return None
    return r.peak_bytes / 2.0 ** 20
