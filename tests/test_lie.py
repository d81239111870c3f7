import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from x_multi_agent_jax.ops import lie


def random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_multiply_matches_scipy(rng):
    q = random_quats(rng, 32)
    p = random_quats(rng, 32)
    got = np.asarray(lie.quat_multiply(jnp.asarray(q), jnp.asarray(p)))
    want = (Rotation.from_quat(q) * Rotation.from_quat(p)).as_quat()
    # quaternion double cover: compare up to sign
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got, sign * want, atol=1e-12)


def test_quat_to_rot_matches_scipy(rng):
    q = random_quats(rng, 32)
    got = np.asarray(lie.quat_to_rot(jnp.asarray(q)))
    want = Rotation.from_quat(q).as_matrix()
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_rot_to_quat_roundtrip(rng):
    q = random_quats(rng, 64)
    q *= np.where(q[:, 3:4] < 0, -1.0, 1.0)
    r = Rotation.from_quat(q).as_matrix()
    got = np.asarray(lie.rot_to_quat(jnp.asarray(r)))
    np.testing.assert_allclose(got, q, atol=1e-9)


def test_skew_cross_product(rng):
    a = rng.normal(size=(16, 3))
    b = rng.normal(size=(16, 3))
    got = np.einsum("nij,nj->ni", np.asarray(lie.skew(jnp.asarray(a))), b)
    np.testing.assert_allclose(got, np.cross(a, b), atol=1e-12)


def test_omega_matrix_kinematics(rng):
    """0.5*Omega(w)@q must equal the xyzw coeffs of 0.5 * q ⊗ (w, 0)."""
    q = random_quats(rng, 16)
    w = rng.normal(size=(16, 3))
    omega = np.asarray(lie.omega_matrix(jnp.asarray(w)))
    got = 0.5 * np.einsum("nij,nj->ni", omega, q)
    w_quat = np.concatenate([w, np.zeros((16, 1))], axis=-1)
    want = 0.5 * np.asarray(
        lie.quat_multiply(jnp.asarray(q), jnp.asarray(w_quat))
    )
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_error_quat_small_angles(rng):
    dtheta = rng.normal(size=(32, 3)) * 0.01
    got = np.asarray(lie.error_quat_from_small_angles(jnp.asarray(dtheta)))
    want = Rotation.from_rotvec(dtheta).as_quat()
    np.testing.assert_allclose(got, want, atol=1e-12)
    # zero maps exactly to identity
    z = np.asarray(lie.error_quat_from_small_angles(jnp.zeros((3,))))
    np.testing.assert_allclose(z, [0, 0, 0, 1], atol=0)


def test_small_angle_roundtrip(rng):
    dtheta = rng.normal(size=(32, 3)) * 0.3
    dq = lie.error_quat_from_small_angles(jnp.asarray(dtheta))
    back = np.asarray(lie.small_angles_from_error_quat(dq))
    np.testing.assert_allclose(back, dtheta, atol=1e-10)
