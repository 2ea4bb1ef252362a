"""Utilities: profiling (a device trace of a block, the program's spans)
and budget plans."""

from sonar_3d_reconstruction_tpu_torch.utils.profiling import (  # noqa: F401
    device_trace,
    span,
)
