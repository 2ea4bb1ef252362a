"""PointCloud2 / marker serialization (vectorized; RViz-compatible bytes; a
copy of ``sonar_3d_reconstruction_tpu.io.pointcloud``).

The reference publishes the map as a PointCloud2 with XYZI float32 layout,
point_step=16, little-endian, probability mapped to the ``intensity`` field —
built with a per-point ``struct.pack`` Python loop (reference
scripts/3d_mapper_node.py:406-443, SURVEY.md 3.3 flags it as a hot path).
Here the same byte layout is produced with one vectorized NumPy copy.

``classified_markers`` implements the INTENDED behavior of the reference's
MarkerArray path (node:448-527): CUBE_LIST markers for occupied (red a=0.8),
free (blue a=0.3) and unknown (yellow a=0.5) voxels, cube scale =
voxel_resolution.  (The reference's own implementation has a latent
``marker.points.add()`` AttributeError, node:475 — never hit because
show_free_space defaults to false; this implements what it meant to do.)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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


# Classified-marker styling, matching the reference constants
# (node:469-473 occupied, 492-496 free, 515-519 unknown).
_MARKER_STYLE = {
    "occupied": {"r": 1.0, "g": 0.0, "b": 0.0, "a": 0.8},
    "free": {"r": 0.0, "g": 0.0, "b": 1.0, "a": 0.3},
    "unknown": {"r": 1.0, "g": 1.0, "b": 0.0, "a": 0.5},
}
_CUBE_LIST = 6  # visualization_msgs/Marker.CUBE_LIST


def classified_markers(
    classified: Dict[str, Tuple[np.ndarray, np.ndarray]],
    voxel_resolution: float,
    frame_id: str = "map",
    stamp: Tuple[int, int] = (0, 0),
) -> List[Dict]:
    """Three CUBE_LIST marker dicts (occupied/free/unknown) from the output
    of grid extraction (models/mapper.get_point_cloud(include_free=True))."""
    markers = []
    for i, name in enumerate(("occupied", "free", "unknown")):
        pts, _probs = classified[name]
        style = _MARKER_STYLE[name]
        markers.append(
            {
                "header": {
                    "frame_id": frame_id,
                    "stamp": {"sec": stamp[0], "nanosec": stamp[1]},
                },
                "ns": f"sonar_3d_map_{name}",
                "id": i,
                "type": _CUBE_LIST,
                "action": 0,  # ADD
                "scale": {
                    "x": voxel_resolution,
                    "y": voxel_resolution,
                    "z": voxel_resolution,
                },
                "color": style,
                "points": np.asarray(pts, np.float64).reshape(-1, 3),
            }
        )
    return markers
