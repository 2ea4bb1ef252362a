"""The port's batched torch pose functions (``geometry.py``) against the
JAX package's on ``tests/test_geometry.py``'s cases, in float64.

All three are bit-equal to JAX's: the rotations and poses are the same
elementwise expressions, and the chain's fixed summation order (j = 0..3,
no fused multiply-add) is the one XLA:CPU's einsum takes.  Against the
host product (NumPy's matmul, ``batched_sonar_to_world``) the chain is
held within 1e-12, test_geometry.py's bar: BLAS may fuse or reorder.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu import geometry as j_geometry  # noqa: E402

from sonar_3d_reconstruction_tpu_torch.config import MapperConfig  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.geometry import (  # noqa: E402
    batched_sonar_to_world,
    compose_pose_chain,
    pose_matrices_from_quaternions,
    pose_matrix_from_quaternion,
    pose_matrix_from_rpy,
    rotations_from_quaternions,
)

CHAIN_TOL = 1e-12


def unit_quaternions(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def case(seed, n):
    """tests/test_geometry.py's poses: seed 3, 17 poses in +-5 m; seed 4,
    5 poses in +-2 m."""
    rng = np.random.default_rng(seed)
    reach = 5 if seed == 3 else 2
    pos = rng.uniform(-reach, reach, (n, 3))
    return pos, unit_quaternions(rng, (n,))


@pytest.mark.parametrize("shape", [(17,), (3, 5), ()])
def test_rotations_from_quaternions_bit_equal_to_jax(shape):
    """Any batch shape, the identity included: bit-equal."""
    rng = np.random.default_rng(3)
    q = unit_quaternions(rng, shape)
    got = rotations_from_quaternions(torch.as_tensor(q)).numpy()
    want = np.asarray(j_geometry.rotations_from_quaternions(jnp.asarray(q)))
    assert got.shape == shape + (3, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    ident = rotations_from_quaternions(torch.tensor([0.0, 0.0, 0.0, 1.0],
                                                    dtype=torch.float64))
    np.testing.assert_array_equal(ident.numpy(), np.eye(3))


@pytest.mark.parametrize("seed,n", [(3, 17), (4, 5)])
def test_pose_matrices_from_quaternions_bit_equal_to_jax(seed, n):
    """Batched poses bit-equal to JAX's and within 1e-12 of the host
    function, pose by pose (test_geometry.py's bar)."""
    pos, q = case(seed, n)
    got = pose_matrices_from_quaternions(torch.as_tensor(pos),
                                         torch.as_tensor(q)).numpy()
    want = np.asarray(j_geometry.pose_matrices_from_quaternions(
        jnp.asarray(pos), jnp.asarray(q)))
    assert got.shape == (n, 4, 4)
    np.testing.assert_array_equal(got, want)
    for i in range(n):
        np.testing.assert_allclose(got[i], pose_matrix_from_quaternion(
            pos[i], q[i]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed,n", [(3, 17), (4, 5)])
def test_compose_pose_chain_matches_jax(seed, n):
    """T_base_to_world @ T_mount bit-equal to JAX's einsum, and within
    CHAIN_TOL of the host product, pose by pose."""
    pos, q = case(seed, n)
    T_mount = pose_matrix_from_rpy(np.array([0.0, 0.0, -0.5]),
                                   np.array([0, 1.5708, 0]))
    Tb = pose_matrices_from_quaternions(torch.as_tensor(pos),
                                        torch.as_tensor(q))
    got = compose_pose_chain(Tb, torch.as_tensor(T_mount)).numpy()
    want = np.asarray(j_geometry.compose_pose_chain(
        j_geometry.pose_matrices_from_quaternions(jnp.asarray(pos),
                                                  jnp.asarray(q)),
        jnp.asarray(T_mount)))
    np.testing.assert_array_equal(got, want)
    for i in range(n):
        np.testing.assert_allclose(
            got[i], pose_matrix_from_quaternion(pos[i], q[i]) @ T_mount,
            rtol=0, atol=CHAIN_TOL)


def test_compose_pose_chain_equals_batched_sonar_to_world():
    """The torch chain with the config's mount gives the host's
    ``batched_sonar_to_world`` within CHAIN_TOL, and float32 inputs stay
    float32."""
    cfg = MapperConfig()
    pos, q = case(4, 5)
    T_mount = torch.as_tensor(pose_matrix_from_rpy(
        np.asarray(cfg.sonar_position, np.float64),
        np.asarray(cfg.sonar_orientation, np.float64)))
    Tb = pose_matrices_from_quaternions(torch.as_tensor(pos),
                                        torch.as_tensor(q))
    got = compose_pose_chain(Tb, T_mount).numpy()
    np.testing.assert_allclose(got, batched_sonar_to_world(pos, q, cfg),
                               rtol=0, atol=CHAIN_TOL)
    f32 = compose_pose_chain(Tb.float(), T_mount)
    assert f32.dtype == torch.float32
