"""The stateful mapper API."""

from sonar_3d_reconstruction_tpu_torch.models.mapper import SonarMapper  # noqa: F401
