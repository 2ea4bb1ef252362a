"""SE(3) host pose functions (float64 NumPy), the batched sonar pose chain,
and its batched torch form on the caller's device.

Conventions match the reference (and ``sonar_3d_reconstruction_tpu.geometry``):
RPY is ZYX (yaw*pitch*roll); quaternions are [x, y, z, w], assumed unit and
not normalised.  The mapping paths keep poses float64 on the host
(``batched_sonar_to_world``); the device code receives the cast result.
"""

from __future__ import annotations

import numpy as np
import torch

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig


def rotation_from_rpy(rpy: np.ndarray) -> np.ndarray:
    """3x3 rotation from [roll, pitch, yaw] radians, ZYX convention."""
    cr, sr = np.cos(rpy[0]), np.sin(rpy[0])
    cp, sp = np.cos(rpy[1]), np.sin(rpy[1])
    cy, sy = np.cos(rpy[2]), np.sin(rpy[2])
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def rotation_from_quaternion(q: np.ndarray) -> np.ndarray:
    """3x3 rotation from an [x, y, z, w] quaternion (unnormalised)."""
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _homogeneous(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def pose_matrix_from_rpy(position: np.ndarray, rpy: np.ndarray) -> np.ndarray:
    """4x4 homogeneous transform from translation + RPY."""
    return _homogeneous(rotation_from_rpy(rpy), position)


def pose_matrix_from_quaternion(position: np.ndarray, q: np.ndarray) -> np.ndarray:
    """4x4 homogeneous transform from translation + quaternion."""
    return _homogeneous(rotation_from_quaternion(q), position)


def quaternion_from_rpy(rpy: np.ndarray) -> np.ndarray:
    """[x, y, z, w] quaternion from RPY radians."""
    roll, pitch, yaw = rpy
    cy, sy = np.cos(yaw * 0.5), np.sin(yaw * 0.5)
    cp, sp = np.cos(pitch * 0.5), np.sin(pitch * 0.5)
    cr, sr = np.cos(roll * 0.5), np.sin(roll * 0.5)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def rotations_from_quaternions_np(q: np.ndarray) -> np.ndarray:
    """(N, 4) xyzw quaternions -> (N, 3, 3) float64 rotations."""
    q = np.asarray(q, np.float64)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3), np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def batched_sonar_to_world(
    positions: np.ndarray,
    quaternions: np.ndarray,
    cfg: MapperConfig,
) -> np.ndarray:
    """(P, 3) positions + (P, 4) xyzw quaternions -> (P, 4, 4) float64
    T_sonar_to_world = T_base_to_world @ T_sonar_to_base."""
    positions = np.asarray(positions, np.float64)
    R = rotations_from_quaternions_np(quaternions)
    P = len(R)
    T = np.zeros((P, 4, 4), np.float64)
    T[:, :3, :3] = R
    T[:, :3, 3] = positions
    T[:, 3, 3] = 1.0
    T_s2b = pose_matrix_from_rpy(
        np.asarray(cfg.sonar_position, np.float64),
        np.asarray(cfg.sonar_orientation, np.float64),
    )
    return T @ T_s2b


# ---------------------------------------------------------------------------
# Batched torch versions (the caller's device and dtype)
# ---------------------------------------------------------------------------


def rotations_from_quaternions(q: torch.Tensor) -> torch.Tensor:
    """Batched [..., 4] xyzw quaternions -> [..., 3, 3] rotation matrices."""
    x, y, z, w = q.unbind(-1)
    one = torch.ones_like(x)
    rows = [
        [one - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), one - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), one - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pose_matrices_from_quaternions(
    positions: torch.Tensor, quaternions: torch.Tensor
) -> torch.Tensor:
    """Batched [..., 3] positions + [..., 4] quaternions -> [..., 4, 4]."""
    R = rotations_from_quaternions(quaternions)
    top = torch.cat([R, positions[..., :, None].to(R.dtype)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def compose_pose_chain(
    T_base_to_world: torch.Tensor, T_sonar_to_base: torch.Tensor
) -> torch.Tensor:
    """Batched T_sonar_to_world = T_base_to_world @ T_sonar_to_base
    (reference 3d_mapper.py:519-521): [..., 4, 4] poses and one (4, 4)
    mount.  The products are summed in a fixed order (j = 0..3), one
    elementwise pass each, so the card and the CPU give the same bits."""
    B = T_sonar_to_base.to(T_base_to_world)
    out = T_base_to_world[..., :, 0:1] * B[0]
    for j in range(1, 4):
        out = out + T_base_to_world[..., :, j:j + 1] * B[j]
    return out
