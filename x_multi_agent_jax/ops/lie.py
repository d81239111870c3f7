"""Quaternion / SO(3) primitives.

Conventions (behavioral spec: reference `include/x/common/types.h`,
`common/eigen_matrix_base_plugin.h:32-63`, `src/x/ekf/state.cpp:197-249`):

  * quaternions are stored **(x, y, z, w)**, Hamilton product, unit norm;
    ``quat_to_rot(q)`` is Eigen's ``toRotationMatrix`` (maps body -> world
    when q is the world<-body attitude)
  * ``omega_matrix`` is Trawny eq. (108) adapted to xyzw coefficient order,
    used by the quaternion kinematics  q_dot = 0.5 * Omega(w) @ q
  * small-angle error quaternions use the exact angle-axis map
    (reference ``State::errorQuatFromSmallAngles``)

Everything is shape-polymorphic over leading batch dimensions and
dtype-polymorphic (float32 on the GPU, float64 in CPU oracle tests).
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "quat_identity",
    "quat_multiply",
    "quat_conjugate",
    "quat_normalize",
    "quat_to_rot",
    "rot_to_quat",
    "skew",
    "omega_matrix",
    "error_quat_from_small_angles",
    "small_angles_from_error_quat",
]


def quat_identity(dtype=jnp.float32):
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_multiply(q: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product q ⊗ p, both xyzw, broadcastable."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return jnp.stack(
        [
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
            qw * pw - qx * px - qy * py - qz * pz,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix of a unit xyzw quaternion (Eigen ``toRotationMatrix``)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(r: jnp.ndarray) -> jnp.ndarray:
    """Shepperd's method, branch-free (computes all four candidates and picks
    the best-conditioned one with jnp.where — no data-dependent control
    flow). Returns xyzw with w >= 0."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate (unnormalized) quaternions, one per dominant diagonal
    qw0 = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1 + tr], axis=-1)
    qx0 = jnp.stack(
        [1 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1
    )
    qy0 = jnp.stack(
        [m01 + m10, 1 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1
    )
    qz0 = jnp.stack(
        [m02 + m20, m12 + m21, 1 - m00 - m11 + m22, m10 - m01], axis=-1
    )

    scores = jnp.stack(
        [1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)[..., None]
    q = jnp.where(
        best == 0, qw0, jnp.where(best == 1, qx0, jnp.where(best == 2, qy0, qz0))
    )
    q = quat_normalize(q)
    return jnp.where(q[..., 3:4] < 0, -q, q)


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """3-vector -> cross-product matrix (reference ``toCrossMatrix``)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def omega_matrix(w: jnp.ndarray) -> jnp.ndarray:
    """Angular rate -> 4x4 quaternion differentiation matrix.

    Trawny eq. (108) in xyzw coefficient order (reference
    ``toOmegaMatrix``): q_dot = 0.5 * Omega(w) @ q  with q as xyzw coeffs.
    """
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack(
        [
            zero, z, -y, x,
            -z, zero, x, y,
            y, -x, zero, z,
            -x, -y, -z, zero,
        ],
        axis=-1,
    )
    return m.reshape(w.shape[:-1] + (4, 4))


def error_quat_from_small_angles(dtheta: jnp.ndarray) -> jnp.ndarray:
    """Exact angle-axis error quaternion from a small-angle 3-vector.

    Matches reference ``State::errorQuatFromSmallAngles`` (exact AngleAxis,
    identity at ||dtheta|| = 0), made branch-free with a Taylor-guarded
    sinc: q = (sin(a/2)/a * dtheta, cos(a/2)) with a = ||dtheta||.
    """
    a2 = jnp.sum(dtheta * dtheta, axis=-1, keepdims=True)
    a = jnp.sqrt(a2)
    small = a2 < jnp.asarray(1e-12, dtheta.dtype)
    safe_a = jnp.where(small, jnp.ones_like(a), a)
    # sin(a/2)/a, Taylor: 1/2 - a^2/48 + a^4/3840
    s = jnp.where(
        small, 0.5 - a2 / 48.0, jnp.sin(safe_a * 0.5) / safe_a
    )
    return jnp.concatenate([dtheta * s, jnp.cos(a * 0.5)], axis=-1)


def small_angles_from_error_quat(dq: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`error_quat_from_small_angles` (for tests/NEES)."""
    v = dq[..., :3]
    w = dq[..., 3:4]
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(n, w)
    small = n < jnp.asarray(1e-12, dq.dtype)
    safe_n = jnp.where(small, jnp.ones_like(n), n)
    return jnp.where(small, 2.0 * v, v / safe_n * angle)
