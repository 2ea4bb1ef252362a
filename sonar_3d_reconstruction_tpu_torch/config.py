"""Mapper configuration for the PyTorch port.

The field surface, defaults and units are those of
``sonar_3d_reconstruction_tpu.config`` (the reference library defaults):
``MapperConfig``, ``StreamConfig``, ``config_from_dict``, ``load_config``
(overrides > YAML > defaults) and the named presets.  The module is repeated
here so that the port never imports the JAX package;
``tests/test_torch_ops.py`` and ``tests/test_torch_mapper.py`` hold the two
equal.  Orientation is radians inside the library and degrees in YAML and
node-level overrides (``load_config`` converts once); FOV and aperture are
degrees everywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple


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

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["sonar_position"] = list(self.sonar_position)
        d["sonar_orientation"] = list(self.sonar_orientation)
        return d


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Runtime / streaming parameters (reference node-level surface,
    scripts/3d_mapper_node.py:89-107 and config/3d_mapper.yaml:58-84)."""

    show_free_space: bool = False
    show_opencv_visualization: bool = False

    sonar_frame_id: str = "sonar_link"
    base_frame_id: str = "base_link"
    map_frame_id: str = "map"
    publish_tf: bool = True

    sonar_topic: str = "/sensor/sonar/oculus/m750d/image"
    odometry_topic: str = "/fast_lio/odometry"
    pointcloud_topic: str = "/sonar_3d_map"
    marker_topic: str = "/sonar_3d_map_markers"

    publish_rate_hz: float = 10.0        # node:227-231 fixed 10 Hz timer
    sync_slop: float = 0.1               # node:210 ApproximateTimeSynchronizer slop
    sync_queue_size: int = 10            # node:209

    use_sim_time: bool = False
    bag_file: str = ""
    bag_playback_rate: float = 1.0


# Keys of MapperConfig that may appear in a flat override mapping.
_MAPPER_KEYS = {f.name for f in dataclasses.fields(MapperConfig)}
_STREAM_KEYS = {f.name for f in dataclasses.fields(StreamConfig)}


def _as_tuple3(v: Any) -> Tuple[float, float, float]:
    t = tuple(float(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 elements, got {v!r}")
    return t  # type: ignore[return-value]


def config_from_dict(d: Mapping[str, Any]) -> MapperConfig:
    """Build a MapperConfig from a flat library-level dict (radians orientation),
    replicating ``default_config.update(config)`` (reference 3d_mapper.py:252-254):
    unknown keys are ignored, provided keys override defaults."""
    kw: Dict[str, Any] = {}
    for k, v in d.items():
        if k not in _MAPPER_KEYS:
            continue
        if k in ("sonar_position", "sonar_orientation"):
            kw[k] = _as_tuple3(v)
        else:
            kw[k] = v
    return MapperConfig(**kw)


def _flatten_yaml_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Flatten the reference YAML schema: nested ``sonar_position{x,y,z}`` and
    ``sonar_orientation{roll,pitch,yaw}`` (degrees) become the library's list
    forms, with the deg->rad conversion the node performs
    (reference scripts/3d_mapper_node.py:124-133)."""
    flat: Dict[str, Any] = dict(params)
    sp = flat.pop("sonar_position", None)
    if isinstance(sp, Mapping):
        flat["sonar_position"] = [sp.get("x", 0.0), sp.get("y", 0.0), sp.get("z", 0.0)]
    elif sp is not None:
        flat["sonar_position"] = sp
    so = flat.pop("sonar_orientation", None)
    if isinstance(so, Mapping):
        flat["sonar_orientation"] = [
            math.radians(float(so.get("roll", 0.0))),
            math.radians(float(so.get("pitch", 0.0))),
            math.radians(float(so.get("yaw", 0.0))),
        ]
    elif so is not None:
        # already a flat list: treat as degrees (node-level convention)
        flat["sonar_orientation"] = [math.radians(float(x)) for x in so]
    return flat


def load_config(
    yaml_path: Optional[str] = None,
    overrides: Optional[Mapping[str, Any]] = None,
) -> Tuple[MapperConfig, StreamConfig]:
    """Load configuration with the reference priority: overrides > YAML > defaults.

    ``yaml_path`` accepts the exact reference YAML schema
    (``sonar_3d_mapper: ros__parameters: ...``) or a flat mapping.
    ``overrides`` is a flat mapping in node-level units (orientation degrees
    when given as a nested/flat ``sonar_orientation``).
    """
    merged: Dict[str, Any] = {}
    if yaml_path:
        import yaml  # lazy: PyYAML is only needed when loading files

        with open(yaml_path, "r") as f:
            raw = yaml.safe_load(f) or {}
        params = raw
        if isinstance(raw, Mapping) and "sonar_3d_mapper" in raw:
            node_section = raw["sonar_3d_mapper"] or {}
            params = node_section.get("ros__parameters") or {}
        merged.update(_flatten_yaml_params(params or {}))
    if overrides:
        merged.update(_flatten_yaml_params(overrides))

    mapper = config_from_dict(merged)
    stream_kw = {k: v for k, v in merged.items() if k in _STREAM_KEYS}
    return mapper, StreamConfig(**stream_kw)


# ---------------------------------------------------------------------------
# Named presets replicating the reference field-trial configs
# (config/3d_mapper.yaml active=tilt60; config/3d_mapper.yaml.bak90=tilt90,
# survey SURVEY.md section 2.5).
# ---------------------------------------------------------------------------

def _preset(overrides: Dict[str, Any]) -> MapperConfig:
    return config_from_dict(_flatten_yaml_params(overrides))


PRESETS: Dict[str, MapperConfig] = {
    # Production 60-degree-tilt water-tank experiment (config/3d_mapper.yaml)
    "kiro_tilt60": _preset(
        dict(
            horizontal_fov=70.0,
            vertical_aperture=20.0,
            max_range=10.0,
            min_range=1.0,
            intensity_threshold=120,
            sonar_position={"x": 0.0, "y": 0.0, "z": -0.1},
            sonar_orientation={"roll": 0.0, "pitch": 60.0, "yaw": 0.0},
            voxel_resolution=0.15,
            min_probability=0.7,
            dynamic_expansion=True,
            z_filter_min=-6.3,
            z_filter_enabled=True,
            adaptive_update=True,
            adaptive_threshold=0.5,
            adaptive_max_ratio=0.3,
            log_odds_occupied=0.5,
            log_odds_free=-0.1,
            log_odds_min=-10.0,
            log_odds_max=7.0,
        )
    ),
    # 90-degree-tilt gain-50 experiment (config/3d_mapper.yaml.bak90)
    "kiro_tilt90": _preset(
        dict(
            horizontal_fov=70.0,
            vertical_aperture=20.0,
            max_range=10.0,
            min_range=1.0,
            intensity_threshold=85,
            sonar_position={"x": 0.0, "y": 0.0, "z": -0.1},
            sonar_orientation={"roll": 0.0, "pitch": 90.0, "yaw": 0.0},
            voxel_resolution=0.15,
            min_probability=0.8,
            dynamic_expansion=True,
            z_filter_min=-6.5,
            z_filter_enabled=True,
            adaptive_update=True,
            adaptive_threshold=0.5,
            adaptive_max_ratio=0.3,
            log_odds_occupied=0.5,
            log_odds_free=-0.3,
            log_odds_min=-10.0,
            log_odds_max=7.0,
        )
    ),
    # Library defaults (reference 3d_mapper.py:220-250)
    "library_default": MapperConfig(),
}
