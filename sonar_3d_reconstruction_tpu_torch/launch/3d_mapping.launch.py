#!/usr/bin/env python3
"""ROS2 launch orchestration for the PyTorch + CUDA mapping node.

Run from a source checkout with a ROS2 environment:

    ros2 launch sonar_3d_reconstruction_tpu_torch/launch/3d_mapping.launch.py

It composes what the reference's launch file does
(reference launch/3d_mapping.launch.py:20-203):

  * the same 11 CLI-overridable launch arguments, with defaults seeded by
    parsing the mapper YAML at generation time (reference launch:30-34),
    so every YAML value stays overridable from the command line;
  * Fast-LIO's own mapping.launch.py included with its RViz disabled
    (reference launch:121-131), gated by ``launch_fast_lio``;
  * the mapper node, ``python3 -m sonar_3d_reconstruction_tpu_torch.node``,
    with ``--ros-args --params-file <yaml> -p ...`` layering (CLI > YAML >
    launch > node defaults > library defaults).  The node maps on the
    first visible card unless the YAML's ``device`` parameter names
    another device;
  * RViz with the repository's profile, gated by ``launch_rviz``;
  * ``ros2 bag play --clock --rate`` and ``ros2 bag record -a`` processes
    gated by ``play_bag`` / ``record_bag``.

The config path is resolved from the source tree (``config/
kiro_tilt60.yaml``; ``SONAR3D_CONFIG`` names another), so YAML edits
apply without a rebuild.  This directory holds no ``__init__.py``, so it
never shadows ROS2's own ``launch`` package.
"""

import os
import sys

from launch import LaunchDescription
from launch.actions import (
    DeclareLaunchArgument,
    ExecuteProcess,
    IncludeLaunchDescription,
)
from launch.conditions import IfCondition
from launch.launch_description_sources import PythonLaunchDescriptionSource
from launch.substitutions import LaunchConfiguration

# the checkout's root: <root>/sonar_3d_reconstruction_tpu_torch/launch/
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CONFIG = os.path.join(_ROOT, "config", "kiro_tilt60.yaml")
RVIZ_PROFILE = os.path.join(_ROOT, "rviz", "sonar3d_mapping.rviz")
NODE_MODULE = "sonar_3d_reconstruction_tpu_torch.node"

# (name, yaml key or None, fallback, description)
LAUNCH_ARGS = [
    ("use_sim_time", "use_sim_time", "true",
     "Use simulation time for bag playback"),
    ("launch_fast_lio", "launch_fast_lio", "true",
     "Launch Fast-LIO for odometry"),
    ("launch_rviz", "launch_rviz", "true",
     "Launch RViz for visualization"),
    ("play_bag", "play_bag", "false", "Play a recorded bag"),
    ("bag_file", "bag_file", "", "Path to the bag to replay"),
    ("bag_playback_rate", "bag_playback_rate", "1.0",
     "Bag playback rate (1.0 = real time)"),
    ("record_bag", None, "false", "Record all topics while mapping"),
    ("record_output_path", None, "/tmp/sonar3d_recording",
     "Recorded bag output path"),
    ("sonar_orientation.roll", ("sonar_orientation", "roll"), "0.0",
     "Sonar roll angle in degrees"),
    ("sonar_orientation.pitch", ("sonar_orientation", "pitch"), "0.0",
     "Sonar pitch angle in degrees"),
    ("sonar_orientation.yaw", ("sonar_orientation", "yaw"), "0.0",
     "Sonar yaw angle in degrees"),
]


def _yaml_defaults(config_path):
    """Mapper YAML -> {launch arg name: default string} (generation-time
    parse, the mechanism that makes YAML values CLI-overridable)."""
    try:
        import yaml

        with open(config_path) as f:
            params = yaml.safe_load(f)["sonar_3d_mapper"]["ros__parameters"]
    except Exception:
        params = {}
    out = {}
    for name, key, fallback, _desc in LAUNCH_ARGS:
        if key is None:
            out[name] = fallback
        elif isinstance(key, tuple):
            out[name] = str(params.get(key[0], {}).get(key[1], fallback))
        else:
            out[name] = str(params.get(key, fallback))
    return out


def generate_launch_description():
    config = os.environ.get("SONAR3D_CONFIG", DEFAULT_CONFIG)
    defaults = _yaml_defaults(config)

    ld = LaunchDescription()
    for name, _key, _fb, desc in LAUNCH_ARGS:
        ld.add_action(DeclareLaunchArgument(
            name, default_value=defaults[name], description=desc
        ))

    use_sim_time = LaunchConfiguration("use_sim_time")

    # Fast-LIO odometry (its RViz off; ours owns visualization)
    try:
        from ament_index_python.packages import get_package_share_directory

        fast_lio_pkg = get_package_share_directory("fast_lio")
    except Exception:
        fast_lio_pkg = None
    if fast_lio_pkg:
        ld.add_action(IncludeLaunchDescription(
            PythonLaunchDescriptionSource(
                os.path.join(fast_lio_pkg, "launch", "mapping.launch.py")
            ),
            launch_arguments={
                "use_sim_time": use_sim_time,
                "rviz": "false",
                "config_file": "mid360.yaml",
            }.items(),
            condition=IfCondition(LaunchConfiguration("launch_fast_lio")),
        ))

    # The mapper node: module entry point with full 5-level parameter
    # layering (CLI -p > YAML > these launch params > node defaults >
    # library defaults)
    ld.add_action(ExecuteProcess(
        cmd=[
            sys.executable, "-m", NODE_MODULE,
            "--ros-args",
            "--params-file", config,
            "-p", ["use_sim_time:=", use_sim_time],
            "-p", ["sonar_orientation.roll:=",
                   LaunchConfiguration("sonar_orientation.roll")],
            "-p", ["sonar_orientation.pitch:=",
                   LaunchConfiguration("sonar_orientation.pitch")],
            "-p", ["sonar_orientation.yaw:=",
                   LaunchConfiguration("sonar_orientation.yaw")],
        ],
        name="sonar_3d_mapper",
        output="screen",
    ))

    ld.add_action(ExecuteProcess(
        cmd=["rviz2", "-d", RVIZ_PROFILE],
        name="rviz2",
        output="screen",
        condition=IfCondition(LaunchConfiguration("launch_rviz")),
    ))

    ld.add_action(ExecuteProcess(
        cmd=[
            "ros2", "bag", "play", LaunchConfiguration("bag_file"),
            "--clock", "--rate", LaunchConfiguration("bag_playback_rate"),
        ],
        output="screen",
        condition=IfCondition(LaunchConfiguration("play_bag")),
    ))

    ld.add_action(ExecuteProcess(
        cmd=[
            "ros2", "bag", "record", "-a",
            "-o", LaunchConfiguration("record_output_path"),
        ],
        output="screen",
        condition=IfCondition(LaunchConfiguration("record_bag")),
    ))

    return ld
