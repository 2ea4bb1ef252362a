"""PointCloud2 serialization (vectorized; RViz-compatible bytes; the cloud
half of ``sonar_3d_reconstruction_tpu.io.pointcloud``).

The reference publishes the map as a PointCloud2 with XYZI float32 layout,
point_step=16, little-endian, probability mapped to the ``intensity`` field —
built with a per-point ``struct.pack`` Python loop (reference
scripts/3d_mapper_node.py:406-443, SURVEY.md 3.3 flags it as a hot path).
Here the same byte layout is produced with one vectorized NumPy copy.
The classified markers wait for the node (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# sensor_msgs/PointField datatype constant for FLOAT32
_FLOAT32 = 7

POINT_FIELDS = (
    {"name": "x", "offset": 0, "datatype": _FLOAT32, "count": 1},
    {"name": "y", "offset": 4, "datatype": _FLOAT32, "count": 1},
    {"name": "z", "offset": 8, "datatype": _FLOAT32, "count": 1},
    {"name": "intensity", "offset": 12, "datatype": _FLOAT32, "count": 1},
)
POINT_STEP = 16  # bytes (node:430)


def serialize_pointcloud2(
    points: np.ndarray,
    intensities: np.ndarray,
    frame_id: str = "map",
    stamp: Tuple[int, int] = (0, 0),
) -> Dict:
    """(N, 3) points + (N,) intensities -> PointCloud2-shaped dict whose
    ``data`` bytes are exactly what the reference node publishes
    (node:419-443): packed little-endian float32 x,y,z,intensity."""
    n = len(points)
    xyzi = np.empty((n, 4), dtype="<f4")
    if n:
        xyzi[:, :3] = points
        xyzi[:, 3] = intensities
    return {
        "header": {"frame_id": frame_id, "stamp": {"sec": stamp[0], "nanosec": stamp[1]}},
        "height": 1,
        "width": n,
        "fields": POINT_FIELDS,
        "is_bigendian": False,
        "point_step": POINT_STEP,
        "row_step": POINT_STEP * n,
        "data": xyzi.tobytes(),
        "is_dense": True,
    }


def parse_pointcloud2(msg: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of serialize_pointcloud2 (testing / downstream consumers)."""
    n = msg["width"] * msg["height"]
    xyzi = np.frombuffer(msg["data"], "<f4").reshape(n, 4)
    return xyzi[:, :3].copy(), xyzi[:, 3].copy()
