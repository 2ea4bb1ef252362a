"""The port's ``utils/profiling``: ``device_trace`` writes a Chrome trace
(here of the CPU: no card).  ``span`` is held in tests/test_torch_spans.py."""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu_torch.utils import device_trace  # noqa: E402


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the block's host ops; the file is a
    Chrome trace in the named directory, which is created."""
    log_dir = str(tmp_path / "trace")
    x = torch.arange(4096, dtype=torch.float64)
    with device_trace(log_dir) as prof:
        torch.cumsum(x, dim=0)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)
    assert any(e.key == "aten::cumsum" for e in prof.key_averages())
