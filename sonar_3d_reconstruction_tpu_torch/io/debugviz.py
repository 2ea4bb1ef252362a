"""Sonar debug visualization (reference ``show_opencv_visualization``; a copy
of ``sonar_3d_reconstruction_tpu.io.debugviz``).

The reference node optionally shows the incoming polar image with the
intensity threshold overlaid in red and the first-hit per bearing in green
(scripts/3d_mapper_node.py:249-292).  Here the overlay is produced as a
plain RGB ndarray so it works headless (tests, notebooks, file export);
``show`` uses OpenCV only if it happens to be installed.
"""

from __future__ import annotations

import os

import numpy as np

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig


def threshold_overlay(
    polar_image: np.ndarray,
    cfg: MapperConfig,
) -> np.ndarray:
    """(R, B) uint8 polar ping -> (R, B, 3) uint8 RGB debug image.

    Grayscale base; pixels above ``intensity_threshold`` tinted red; the
    first hit of each bearing column marked green (the ray's occupied-window
    start, reference 3d_mapper.py:406-409).
    """
    img = np.asarray(polar_image, np.uint8)
    rgb = np.repeat(img[:, :, None], 3, axis=2).astype(np.uint8)
    above = img > cfg.intensity_threshold
    # red tint for above-threshold returns
    rgb[above, 0] = np.minimum(255, img[above].astype(np.int32) + 80).astype(np.uint8)
    rgb[above, 2] = (img[above] // 2).astype(np.uint8)
    # green marker at first hit per bearing
    any_hit = above.any(axis=0)
    first = np.argmax(above, axis=0)
    cols = np.nonzero(any_hit)[0]
    rgb[first[cols], cols] = (0, 255, 0)
    return rgb


def show(
    polar_image: np.ndarray,
    cfg: MapperConfig,
    window: str = "sonar_3d_mapper debug",
    wait_ms: int = 1,
) -> np.ndarray:
    """Display the overlay in an OpenCV window when cv2 is available AND a
    display exists; always returns the overlay array.

    Headless guard: cv2.imshow without a windowing backend does not raise —
    it aborts the process — so the display attempt is gated on $DISPLAY /
    $WAYLAND_DISPLAY being set (the reference node assumes a desktop,
    scripts/3d_mapper_node.py:288-290)."""
    rgb = threshold_overlay(polar_image, cfg)
    if os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"):
        try:  # pragma: no cover - optional dependency + needs a desktop
            import cv2
        except ImportError:
            return rgb
        cv2.imshow(window, rgb[:, :, ::-1])  # BGR
        cv2.waitKey(wait_ms)
    return rgb
