"""The port's ROS2 launch file
(``sonar_3d_reconstruction_tpu_torch/launch/3d_mapping.launch.py``)
through stub launch modules (no ROS2 here), held against the JAX
package's ``launch/3d_mapping.launch.py`` loaded through the same stubs:
the same 11 arguments and YAML defaults, the same Fast-LIO include,
RViz and bag gates, and a mapper process that starts the port's node
with the same parameter layering.
"""

import ast
import importlib.util
import os
import sys
import types

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_LAUNCH = os.path.join(_REPO, "sonar_3d_reconstruction_tpu_torch",
                           "launch", "3d_mapping.launch.py")
JAX_LAUNCH = os.path.join(_REPO, "launch", "3d_mapping.launch.py")
PORT_NODE = "sonar_3d_reconstruction_tpu_torch.node"
JAX_NODE = "sonar_3d_reconstruction_tpu.node"

_STUBS = [
    "launch", "launch.actions", "launch.conditions",
    "launch.launch_description_sources", "launch.substitutions",
    "ament_index_python", "ament_index_python.packages",
]


class _Rec:
    """Recording stand-in for launch actions and substitutions."""

    def __init__(self, *a, **kw):
        self.args = a
        self.kwargs = kw


class LaunchDescription:
    def __init__(self):
        self.actions = []

    def add_action(self, a):
        self.actions.append(a)


class DeclareLaunchArgument(_Rec):
    @property
    def name(self):
        return self.args[0]


class ExecuteProcess(_Rec):
    pass


class IncludeLaunchDescription(_Rec):
    pass


class IfCondition(_Rec):
    pass


class LaunchConfiguration(_Rec):
    @property
    def name(self):
        return self.args[0]


class PythonLaunchDescriptionSource(_Rec):
    pass


def _stub_modules(fast_lio_share=None):
    """{name: stub module}; ``get_package_share_directory`` resolves
    ``fast_lio_share`` when given, else raises (no ament index)."""
    launch = types.ModuleType("launch")
    launch.LaunchDescription = LaunchDescription
    actions = types.ModuleType("launch.actions")
    actions.DeclareLaunchArgument = DeclareLaunchArgument
    actions.ExecuteProcess = ExecuteProcess
    actions.IncludeLaunchDescription = IncludeLaunchDescription
    conditions = types.ModuleType("launch.conditions")
    conditions.IfCondition = IfCondition
    sources = types.ModuleType("launch.launch_description_sources")
    sources.PythonLaunchDescriptionSource = PythonLaunchDescriptionSource
    subs = types.ModuleType("launch.substitutions")
    subs.LaunchConfiguration = LaunchConfiguration
    launch.actions, launch.conditions = actions, conditions
    launch.launch_description_sources, launch.substitutions = sources, subs
    ament = types.ModuleType("ament_index_python")
    packages = types.ModuleType("ament_index_python.packages")

    def get_package_share_directory(name):
        if fast_lio_share is None:
            raise KeyError(name)
        return fast_lio_share

    packages.get_package_share_directory = get_package_share_directory
    ament.packages = packages
    return {
        "launch": launch, "launch.actions": actions,
        "launch.conditions": conditions,
        "launch.launch_description_sources": sources,
        "launch.substitutions": subs,
        "ament_index_python": ament,
        "ament_index_python.packages": packages,
    }


def describe(path, fast_lio_share=None, config=None):
    """The launch file at ``path`` loaded under the stubs and its
    ``generate_launch_description()`` (``SONAR3D_CONFIG`` = ``config``
    when given)."""
    displaced = {n: sys.modules.get(n) for n in _STUBS}
    env_before = os.environ.get("SONAR3D_CONFIG")
    sys.modules.update(_stub_modules(fast_lio_share))
    if config is not None:
        os.environ["SONAR3D_CONFIG"] = config
    try:
        spec = importlib.util.spec_from_file_location(
            "sonar3d_port_launch_under_test", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.generate_launch_description()
    finally:
        for n in _STUBS:
            if displaced[n] is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = displaced[n]
        if env_before is None:
            os.environ.pop("SONAR3D_CONFIG", None)
        else:
            os.environ["SONAR3D_CONFIG"] = env_before


def declared(ld):
    return {a.name: (a.kwargs["default_value"], a.kwargs["description"])
            for a in ld.actions if isinstance(a, DeclareLaunchArgument)}


def processes(ld):
    return [a for a in ld.actions if isinstance(a, ExecuteProcess)]


def layering(cmd):
    """A mapper command's parameter layering: the params file and each
    ``-p`` override as (key, launch argument or value)."""
    overrides = []
    for i, c in enumerate(cmd):
        if c == "-p":
            key, value = cmd[i + 1]
            overrides.append((key, getattr(value, "name", value)))
    return cmd[cmd.index("--params-file") + 1], overrides


def mapper(ld, module):
    (proc,) = [p for p in processes(ld) if module in p.kwargs["cmd"]]
    return proc


@pytest.mark.parametrize("config", [None, "kiro_tilt90.yaml"])
def test_arguments_and_defaults_equal_the_jax_launch_files(config):
    """The 11 arguments, their YAML-seeded defaults and descriptions equal
    the JAX launch file's, from the default config and from one named by
    ``SONAR3D_CONFIG``."""
    path = None if config is None else os.path.join(_REPO, "config", config)
    got = declared(describe(PORT_LAUNCH, config=path))
    want = declared(describe(JAX_LAUNCH, config=path))
    assert len(got) == 11 and got == want
    if config is None:
        assert got["sonar_orientation.pitch"][0] == "60.0"
        assert got["bag_playback_rate"][0] == "0.5"


def test_mapper_process_starts_the_port_node_with_the_same_layering():
    """The mapper runs ``-m sonar_3d_reconstruction_tpu_torch.node`` with
    the JAX file's params file and ``-p`` overrides, ungated; nothing
    starts the JAX node."""
    ld, j_ld = describe(PORT_LAUNCH), describe(JAX_LAUNCH)
    proc, j_proc = mapper(ld, PORT_NODE), mapper(j_ld, JAX_NODE)
    cmd = proc.kwargs["cmd"]
    assert cmd[:3] == [sys.executable, "-m", PORT_NODE]
    assert cmd[3] == "--ros-args"
    assert layering(cmd) == layering(j_proc.kwargs["cmd"])
    params_file, overrides = layering(cmd)
    assert params_file == os.path.join(_REPO, "config", "kiro_tilt60.yaml")
    assert [k for k, _ in overrides] == [
        "use_sim_time:=", "sonar_orientation.roll:=",
        "sonar_orientation.pitch:=", "sonar_orientation.yaw:="]
    assert "condition" not in proc.kwargs
    assert proc.kwargs["name"] == j_proc.kwargs["name"] == "sonar_3d_mapper"
    assert not any(JAX_NODE in p.kwargs["cmd"] for p in processes(ld))


def test_gates_and_fast_lio_include_equal_the_jax_launch_files(tmp_path):
    """RViz, bag play and bag record: the same commands under the same
    gates; with a resolvable fast_lio package the same RViz-off include,
    gated by ``launch_fast_lio``, and none without one."""
    def others(ld, node):
        return [(p.kwargs["cmd"], p.kwargs["condition"].args[0].name)
                for p in processes(ld) if node not in p.kwargs["cmd"]]

    def named(cmd):
        return [getattr(c, "name", c) for c in cmd]

    got = others(describe(PORT_LAUNCH), PORT_NODE)
    want = others(describe(JAX_LAUNCH), JAX_NODE)
    assert [(named(c), g) for c, g in got] == [(named(c), g) for c, g in want]
    assert [g for _, g in got] == ["launch_rviz", "play_bag", "record_bag"]
    assert os.path.exists(got[0][0][2])

    share = str(tmp_path)
    includes = []
    for path in (PORT_LAUNCH, JAX_LAUNCH):
        ld = describe(path, fast_lio_share=share)
        (incl,) = [a for a in ld.actions
                   if isinstance(a, IncludeLaunchDescription)]
        la = {k: getattr(v, "name", v)
              for k, v in incl.kwargs["launch_arguments"]}
        includes.append((incl.args[0].args[0], la,
                         incl.kwargs["condition"].args[0].name))
    assert includes[0] == includes[1]
    assert includes[0][1]["rviz"] == "false"
    assert includes[0][2] == "launch_fast_lio"
    assert not any(isinstance(a, IncludeLaunchDescription)
                   for a in describe(PORT_LAUNCH).actions)


def test_launch_file_stands_alone():
    """It imports nothing of jax or of the JAX package (the module name it
    starts is a string), and its directory holds no ``__init__.py`` that
    would shadow ROS2's ``launch`` package."""
    with open(PORT_LAUNCH) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    for name in imported:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "sonar_3d_reconstruction_tpu"), name
    assert imported >= {"launch", "launch.actions", "os", "sys"}
    assert not os.path.exists(os.path.join(os.path.dirname(PORT_LAUNCH),
                                           "__init__.py"))
