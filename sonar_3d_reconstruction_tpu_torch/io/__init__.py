"""Host-side I/O: image decode, PointCloud2 serialization, approximate time
synchronization, rosbag2 / mcap reading and writing, and map snapshots.

Copies of the JAX package's NumPy modules (``image``, ``timesync``,
``pointcloud``, ``native``, ``bag``, ``mcap``), so that the port never
imports it; ``checkpoint`` is the port's own (brick maps, same format).
"""
