"""Batched inverse-depth triangulation (behavioral spec: reference
``src/x/vision/triangulation.cpp``).

Two-view DLT initialization (first/last observation; reference uses
``cv::triangulatePoints``, here a 4x4 SVD) followed by Gauss-Newton
refinement over all observations in (alpha, beta, rho) anchored at the last
observation frame (``triangulation.cpp:102-206``; defaults max_iter=10,
term=1e-5 from ``msckf_update.h:93-96``).

Fixed-shape/mask design: a track occupies a window-aligned (M,) slot array
with a validity mask; invalid observations contribute zero residual rows.
The whole routine vmaps over tracks (and agents).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from . import lie


def _proj(rot_cw: jnp.ndarray, pos_wc: jnp.ndarray) -> jnp.ndarray:
    """3x4 projection [R_cw | -R_cw p] (reference pose2proj)."""
    return jnp.concatenate([rot_cw, (-rot_cw @ pos_wc)[:, None]], axis=1)


def triangulate_dlt(
    obs1: jnp.ndarray, obs2: jnp.ndarray, proj1: jnp.ndarray, proj2: jnp.ndarray
) -> jnp.ndarray:
    """Two-view linear triangulation; returns world xyz.

    Same equations as ``cv::triangulatePoints`` (rows x_i*P_i^3 - P_i^{1,2})
    solved in the inhomogeneous form A[:, :3] x = -A[:, 3] via 3x3 normal
    equations (closed-form Cramer solve — no SVD custom call; w=1 is safe
    for finite VIO landmarks)."""
    from . import linalg as _linalg

    rows = jnp.stack(
        [
            obs1[0] * proj1[2] - proj1[0],
            obs1[1] * proj1[2] - proj1[1],
            obs2[0] * proj2[2] - proj2[0],
            obs2[1] * proj2[2] - proj2[1],
        ]
    )
    a = rows[:, :3]
    b = -rows[:, 3]
    ata = a.T @ a + 1e-12 * jnp.eye(3, dtype=rows.dtype)
    return _linalg.solve3(ata, a.T @ b)


def triangulate_gn(
    obs: jnp.ndarray,  # (M, 2) normalized image coords, window-aligned
    mask: jnp.ndarray,  # (M,) bool
    q_wc: jnp.ndarray,  # (M, 4) camera attitudes xyzw (world<-cam)
    p_wc: jnp.ndarray,  # (M, 3) camera positions in world
    max_iter: int = 10,
    term: float = 1e-5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse-depth triangulation of one track.

    Returns ((alpha, beta, rho) anchored at the *last valid* observation
    pose, anchor window index).
    """
    m = obs.shape[0]
    dtype = obs.dtype
    idxs = jnp.arange(m)
    # first and last valid observation indices
    i1 = jnp.argmax(mask)  # first True
    i2 = m - 1 - jnp.argmax(mask[::-1])  # last True

    rot_cw = jnp.swapaxes(lie.quat_to_rot(q_wc), -1, -2)  # (M,3,3) world->cam

    proj1 = _proj(rot_cw[i1], p_wc[i1])
    proj2 = _proj(rot_cw[i2], p_wc[i2])
    pt_w = triangulate_dlt(obs[i1], obs[i2], proj1, proj2)

    # inverse-depth init in the anchor (last) frame
    pt_a = rot_cw[i2] @ (pt_w - p_wc[i2])
    z = pt_a[2]
    init = jnp.stack([pt_a[0] / z, pt_a[1] / z, 1.0 / z])

    rot_a = rot_cw[i2]
    p_a = p_wc[i2]
    # per-frame relative transforms to the anchor
    delta_rot = jnp.einsum("mij,kj->mik", rot_cw, rot_a)  # R_i @ R_a^T
    delta_pos = jnp.einsum("mij,mj->mi", rot_cw, p_a[None] - p_wc)

    eps = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-8, dtype)

    # loop-invariant Jacobian basis, premasked once: columns
    # [j_alpha, j_beta, j_rho] of d(h_i)/d(params). Rebuilding it (and
    # re-masking) inside each unrolled GN step was ~1/3 of the ~450 HLOs
    # per iteration — the GN chain is the dominant sequential-small-op
    # cost of every MSCKF-family builder.
    j0 = jnp.concatenate(
        [delta_rot[:, :, 0:2], delta_pos[:, :, None]], axis=2
    )  # (M,3,3)
    j0 = jnp.where(mask[:, None, None], j0, 0.0)

    def gn_step(carry, _):
        params, r_norm_last, r_norm, active = carry
        alpha, beta, rho = params[0], params[1], params[2]
        h_i = delta_rot @ jnp.stack([alpha, beta, jnp.ones((), dtype)]) + rho * delta_pos
        z_i = h_i[:, 2]
        safe_z = jnp.where(jnp.abs(z_i) < eps, jnp.asarray(1.0, dtype), z_i)
        pred = h_i[:, :2] / safe_z[:, None]
        r = jnp.where(mask[:, None], obs - pred, 0.0)  # (M,2)

        # jac = j1 @ j0 with j1 = d(r)/d(h_i) = [[-1/z, 0, x/z^2],
        # [0, -1/z, y/z^2]] expanded in closed form (no per-step j1
        # assembly / batched einsum):
        #   jac[m, a, k] = -j0[m, a, k]/z + h[m, a] * j0[m, 2, k] / z^2
        # j0 is premasked, so jac rows of masked observations are zero.
        inv_z = 1.0 / safe_z
        jac = (
            -inv_z[:, None, None] * j0[:, :2, :]
            + (h_i[:, :2] * (inv_z * inv_z)[:, None])[:, :, None] * j0[:, 2:3, :]
        )

        from . import linalg as _linalg

        jtj = jnp.einsum("mij,mik->jk", jac, jac)
        jtr = jnp.einsum("mij,mi->j", jac, r)
        delta = _linalg.solve3(jtj + eps * jnp.eye(3, dtype=dtype), jtr)

        new_r_norm = jnp.sqrt(jnp.sum(r * r))
        # termination criterion (reference: while r_norm_last - r_norm > term)
        active = active & (r_norm_last - r_norm > term)
        params = jnp.where(active, params - delta, params)
        return (params, r_norm, new_r_norm, active), None

    big = jnp.asarray(1000.0, dtype)
    carry0 = (init, big, jnp.asarray(100.0, dtype), jnp.asarray(True))
    # fully unrolled: a rolled lax.scan lowers to an HLO while loop that
    # pays a loop trip and its small launches per GN step
    (params, _, _, _), _ = jax.lax.scan(
        gn_step, carry0, None, length=max_iter, unroll=True
    )
    return params, i2


def ivd_to_world(
    ivd: jnp.ndarray, q_wc_anchor: jnp.ndarray, p_wc_anchor: jnp.ndarray
) -> jnp.ndarray:
    """(alpha, beta, rho) in anchor frame -> world point (reference
    ``MsckfUpdate::getGlobalFeaturePosition``)."""
    alpha, beta, rho = ivd[0], ivd[1], ivd[2]
    bearing = jnp.stack([alpha, beta, jnp.ones((), ivd.dtype)])
    return lie.quat_to_rot(q_wc_anchor) @ bearing / rho + p_wc_anchor
