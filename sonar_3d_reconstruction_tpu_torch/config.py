"""Mapper configuration for the PyTorch port.

The field surface, defaults and units are those of
``sonar_3d_reconstruction_tpu.config.MapperConfig`` (the reference library
defaults).  The dataclass is repeated here so that the port never imports the
JAX package; ``tests/test_torch_ops.py`` holds the two field lists and
defaults equal.  Orientation is radians inside the library, FOV and aperture
are degrees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static mapper configuration (hashable, so it can key caches)."""

    # Sonar sensor geometry
    horizontal_fov: float = 130.0        # degrees
    vertical_aperture: float = 20.0      # degrees
    max_range: float = 10.0              # meters
    min_range: float = 0.5               # meters
    intensity_threshold: float = 35.0    # 0-255
    image_width: int = 512               # bearing bins
    image_height: int = 500              # range bins

    # Sonar mounting relative to base frame (meters, RADIANS rpy)
    sonar_position: Tuple[float, float, float] = (0.0, 0.0, -0.5)
    sonar_orientation: Tuple[float, float, float] = (0.0, 1.5708, 0.0)

    # Voxel map
    voxel_resolution: float = 0.05       # meters
    min_probability: float = 0.6
    dynamic_expansion: bool = True

    # Z filtering
    z_filter_min: float = -5.0
    z_filter_enabled: bool = False

    # Adaptive (free-space-protection) update
    adaptive_update: bool = True
    adaptive_threshold: float = 0.5
    adaptive_max_ratio: float = 0.3

    # Log-odds Bayesian update
    log_odds_occupied: float = 1.5
    log_odds_free: float = -2.0
    log_odds_min: float = -10.0
    log_odds_max: float = 10.0

    # Fixed algorithmic constants of the reference hot loop
    free_sampling_step: int = 10
    occupied_window: int = 50
    max_rays: int = 256

    @property
    def horizontal_fov_rad(self) -> float:
        return math.radians(self.horizontal_fov)

    @property
    def vertical_aperture_rad(self) -> float:
        return math.radians(self.vertical_aperture)

    @property
    def half_aperture_rad(self) -> float:
        return math.radians(self.vertical_aperture) / 2.0

    def replace(self, **kw: Any) -> "MapperConfig":
        return dataclasses.replace(self, **kw)
