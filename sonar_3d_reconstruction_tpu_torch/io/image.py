"""Sonar image decoding (cv_bridge replacement; a copy of
``sonar_3d_reconstruction_tpu.io.image``).

The reference decodes sensor_msgs/Image with cv_bridge and handles two
encodings (reference scripts/3d_mapper_node.py:302-316):
  * ``mono8`` / ``8UC1``  -> used directly
  * ``mono16`` / ``16UC1`` -> decoded then scaled ``(img / 256)`` to uint8
  * anything else -> rejected (frame dropped with an error log)

Image buffers are trivially structured, so the decode is pure NumPy —
no OpenCV dependency.
"""

from __future__ import annotations

import numpy as np

MONO8 = ("mono8", "8UC1")
MONO16 = ("mono16", "16UC1")


class UnsupportedEncoding(ValueError):
    """Raised for encodings the reference rejects (node:311-313)."""


def decode_image(
    data: bytes | np.ndarray,
    height: int,
    width: int,
    encoding: str,
    step: int | None = None,
    is_bigendian: bool = False,
) -> np.ndarray:
    """Decode a raw Image payload to the uint8 polar intensity array the
    mapper consumes (rows = range bins, cols = bearings; reference
    3d_mapper.py:508).

    ``step`` is the row stride in bytes (sensor_msgs/Image.step); rows may be
    padded, so each row is sliced to the pixel width.
    """
    if encoding in MONO8:
        itemsize, dtype = 1, np.uint8
    elif encoding in MONO16:
        itemsize = 2
        dtype = np.dtype(">u2") if is_bigendian else np.dtype("<u2")
    else:
        raise UnsupportedEncoding(f"unsupported image encoding: {encoding!r}")

    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    row_bytes = width * itemsize
    if step is None:
        step = row_bytes
    if step < row_bytes:
        step = row_bytes  # tolerate under-reported step (native decoder ditto)
    if buf.size < height * step and buf.size == height * row_bytes:
        step = row_bytes  # tolerate senders that report a padded step
    rows = buf[: height * step].reshape(height, step)[:, :row_bytes]
    img = rows.reshape(height, width) if itemsize == 1 else np.frombuffer(
        np.ascontiguousarray(rows).tobytes(), dtype
    ).reshape(height, width)

    if encoding in MONO16:
        # reference: (mono16 / 256).astype(uint8) (node:308-310)
        img = (img / 256).astype(np.uint8)
    return img
