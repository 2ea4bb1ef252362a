"""Multi-device mapping: the ping stream split by segment through frame
records (``multihost``), and the map sharded over a mesh of devices:
the hash map by the replicated-records engine (``shard``), the brick map
by the frame-parallel engine (``shard_frames``) and the replicated-records
engine (``shard_brick``)."""

from sonar_3d_reconstruction_tpu_torch.parallel.multihost import (  # noqa: F401
    SegmentRecords,
    apply_record_segments,
    map_ping_sequence_multihost,
    records_for_segment,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import (  # noqa: F401
    ShardedHashState,
    gather_sharded_state,
    init_sharded_hash_grid,
    make_mesh,
    map_ping_sequence_sharded,
    rehash_sharded,
    scan_pings_sharded,
    sharded_ping_step,
    window_scan_sharded,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (  # noqa: F401
    ShardedBrickState,
    gather_sharded_brick_state,
    init_sharded_brick_grid,
    local_brick_states,
    map_ping_sequence_sharded_brick,
    rehash_sharded_bricks,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (  # noqa: F401
    map_ping_sequence_sharded_frames,
)
