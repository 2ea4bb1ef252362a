"""Multi-host mapping: the ping stream split by segment through frame
records (``multihost``).  The sharded multi-GPU engines wait for ROADMAP
item 18."""

from sonar_3d_reconstruction_tpu_torch.parallel.multihost import (  # noqa: F401
    SegmentRecords,
    apply_record_segments,
    map_ping_sequence_multihost,
    records_for_segment,
)
