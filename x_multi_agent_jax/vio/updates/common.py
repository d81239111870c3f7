"""Shared geometry for visual update Jacobians.

Frame conventions (match reference): window arrays store camera poses —
``q_wc`` is the world<-camera attitude (xyzw), ``p_wc`` the camera position
in world. The projection Jacobian blocks follow ``msckf_update.cpp:328-417``
and ``slam_update.cpp:115-187``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ...ops import lie


class UpdateRows(NamedTuple):
    """One update constructor's contribution to the stacked system.

    Masked-out rows are identically zero in jac AND res (noise_std stays
    positive so whitening is always defined).
    """

    jac: jnp.ndarray  # (rows, D)
    res: jnp.ndarray  # (rows,)
    noise_std: jnp.ndarray  # (rows,)


def projection_blocks(pt_cam: jnp.ndarray, dtype=None):
    """J_i = d(projection)/d(camera-frame point) (2x3), guarding z ~= 0.

    Returns (J_i, predicted (x/z, y/z), finite-mask).
    """
    dtype = dtype or pt_cam.dtype
    z = pt_cam[2]
    ok = jnp.isfinite(pt_cam).all() & (jnp.abs(z) > 1e-12)
    zs = jnp.where(jnp.abs(z) > 1e-12, z, 1.0)
    inv_z = 1.0 / zs
    pred = pt_cam[:2] * inv_z
    # built in one stack — an .at[i, j].set on a tiny matrix inside a
    # vmapped builder lowers to a full-batch dynamic-update-slice
    # (~0.2 ms/frame each at 128 agents in the device trace)
    zero = jnp.zeros((), dtype)
    j_i = jnp.stack(
        [
            jnp.stack([inv_z, zero, -pt_cam[0] * inv_z * inv_z]),
            jnp.stack([zero, inv_z, -pt_cam[1] * inv_z * inv_z]),
        ]
    ).astype(dtype)
    return j_i, pred, ok


def oc_project(a: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Observability-constrained projection A - A u (u^T u)^-1 u^T
    (Hesch et al. 2012 gravity-nullspace trick, ``msckf_update.cpp:393-406``)."""
    denom = u @ u
    safe = jnp.where(denom > 1e-12, denom, 1.0)
    return a - jnp.outer(a @ u, u) / safe


def scatter_block(h: jnp.ndarray, block: jnp.ndarray, col) -> jnp.ndarray:
    """Add a (rows, 3) block into the full-width Jacobian ``h`` at (possibly
    traced) column offset ``col``.

    Implemented as a one-hot selector matmul, NOT dynamic_update_slice: a
    batch-varying dynamic update under vmap lowers to a serial while-loop
    over the whole batch; the (rows,3)@(3,D) matmul stays a fully batched
    op."""
    d = h.shape[1]
    cols = jnp.arange(d, dtype=jnp.int32)
    tgt = jnp.asarray(col, jnp.int32) + jnp.arange(3, dtype=jnp.int32)
    sel = (cols[None, :] == tgt[:, None]).astype(h.dtype)  # (3, D)
    return h + block @ sel


def pose_pos_col(pose_idx, n_poses: int):
    return 15 + 3 * pose_idx


def pose_att_col(pose_idx, n_poses: int):
    return 15 + 3 * n_poses + 3 * pose_idx


def feature_col(feat_idx, n_poses: int):
    return 15 + 6 * n_poses + 3 * feat_idx
