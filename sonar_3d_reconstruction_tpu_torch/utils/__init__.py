"""Utilities: profiling/tracing and structured per-ping statistics."""

from sonar_3d_reconstruction_tpu_torch.utils.profiling import (  # noqa: F401
    PingStats,
    StatsAggregator,
    device_trace,
    timed,
)
