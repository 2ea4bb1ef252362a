"""Multi-device mapping: the ping stream split by segment through frame
records (``multihost``), and the brick map sharded over a mesh of devices
by the frame-parallel engine (``shard``, ``shard_brick``,
``shard_frames``).  The JAX package's sharded hash engine
(``parallel/shard.py``'s ``ShardedHashState``) is not ported yet."""

from sonar_3d_reconstruction_tpu_torch.parallel.multihost import (  # noqa: F401
    SegmentRecords,
    apply_record_segments,
    map_ping_sequence_multihost,
    records_for_segment,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard import make_mesh  # noqa: F401
from sonar_3d_reconstruction_tpu_torch.parallel.shard_brick import (  # noqa: F401
    ShardedBrickState,
    init_sharded_brick_grid,
)
from sonar_3d_reconstruction_tpu_torch.parallel.shard_frames import (  # noqa: F401
    map_ping_sequence_sharded_frames,
)
