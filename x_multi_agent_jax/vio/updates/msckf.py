"""MSCKF update (opportunistic tracks marginalized via nullspace projection).

Behavioral spec: reference ``src/x/vio/msckf_update.cpp``:
  * Gauss-Newton triangulation of the track over its observation window
  * per-observation reprojection residual + pose Jacobians with the
    observability-constrained (OC) gravity-nullspace projection
    (Hesch et al. 2012, ``msckf_update.cpp:393-406``)
  * left-nullspace projection of the feature Jacobian via Householder QR
    (``msckf_update.cpp:419-432``)
  * chi2(2m - 3, 0.95) Mahalanobis gate (``msckf_update.cpp:452-462``)

Fixed-shape: obs arrays are window-aligned (K tracks x M slots + mask);
each track contributes 2M-3 (padded) rows; gated/invalid tracks contribute
zero rows. Everything vmaps over tracks.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ...ops import lie, linalg, triangulation
from ...utils.chi2 import chi2_gate
from .common import UpdateRows, oc_project, projection_blocks

GRAVITY = (0.0, 0.0, -9.81)  # hard-coded in the reference (msckf_update.cpp:380)


class MsckfTrackInfo(NamedTuple):
    ivd: jnp.ndarray  # (K, 3) triangulated inverse depth (anchor = last obs)
    anchor: jnp.ndarray  # (K,) int32 anchor window index
    world: jnp.ndarray  # (K, 3) triangulated world points
    inlier: jnp.ndarray  # (K,) bool: passed the chi2 gate
    valid: jnp.ndarray  # (K,) bool: had enough observations + finite math


def _obs_jacobians(g_p_f, obs, mask, q_arr, p_arr, g_vec, oc: bool):
    """Per-observation residuals and (position, attitude, feature) blocks.

    Returns res (M,2), j_pos (M,2,3), j_att (M,2,3), hf (M,2,3), finite.
    """
    r_wc = lie.quat_to_rot(q_arr)  # (M,3,3)

    def per_obs(r_wc_i, p_i, z_i, m_i):
        pt_cam = r_wc_i.T @ (g_p_f - p_i)
        j_i, pred, ok = projection_blocks(pt_cam)
        res = z_i - pred
        j_pos = -j_i @ r_wc_i.T
        j_att = j_i @ lie.skew(pt_cam)
        if oc:
            u_pos = r_wc_i @ g_vec
            u_att = lie.skew(g_p_f - p_i) @ g_vec
            j_pos = oc_project(j_pos, u_pos)
            j_att = oc_project(j_att, u_att)
        hf = -j_pos
        keep = m_i
        zero2 = jnp.zeros_like(res)
        zero23 = jnp.zeros_like(j_pos)
        return (
            jnp.where(keep, res, zero2),
            jnp.where(keep, j_pos, zero23),
            jnp.where(keep, j_att, zero23),
            jnp.where(keep, hf, zero23),
            ok | ~m_i,
        )

    res, j_pos, j_att, hf, ok = jax.vmap(per_obs)(r_wc, p_arr, obs, mask)
    return res, j_pos, j_att, hf, ok.all()


def _assemble_h(j_pos, j_att, m: int, n: int, dtype):
    """Scatter per-obs (M,2,3) blocks into (2M, D) at their own window slot
    columns (static block-diagonal placement)."""
    eye_m = jnp.eye(m, dtype=dtype)
    pos_big = jnp.einsum("mab,mn->manb", j_pos, eye_m).reshape(m, 2, 3 * m)
    att_big = jnp.einsum("mab,mn->manb", j_att, eye_m).reshape(m, 2, 3 * m)
    zeros_core = jnp.zeros((m, 2, 15), dtype)
    zeros_feat = jnp.zeros((m, 2, 3 * n), dtype)
    h = jnp.concatenate([zeros_core, pos_big, att_big, zeros_feat], axis=-1)
    return h.reshape(2 * m, 15 + 6 * m + 3 * n)


@linalg.highprec  # residual precision: pred = z(g_p_f; pose) runs through
# 3x3 matvec dots, and reduced-mantissa rounding (~1e-3 relative, as in
# TF32) exceeds sigma_img-level measurement noise — the filter then runs
# overconfident and the f32 covariance blows up to NaN. All three stacked-row builders and the shared
# GN-triangulation chain (it seeds MSCKF-SLAM inits) run at "highest".
def build(
    obs: jnp.ndarray,  # (K, M, 2) normalized coords, window-aligned
    mask: jnp.ndarray,  # (K, M) bool
    q_arr: jnp.ndarray,  # (M, 4)
    p_arr: jnp.ndarray,  # (M, 3)
    cov: jnp.ndarray,  # (D, D)
    sigma_img: float,
    n_features: int,
    max_iter: int = 10,
    term: float = 1e-5,
    oc: bool = True,
    fixed_world=None,
):
    """Returns (UpdateRows with K*(2M-3) rows, MsckfTrackInfo).

    ``fixed_world`` (K, 3): reuse these triangulated world points instead
    of re-triangulating — REQUIRED for IEKF iterations > 0. Re-running the
    GN triangulation against the corrected state lets the feature point
    absorb each correction, so the accumulated-correction residual form
    K(res + H corr_tot) - corr_tot (updater.cpp:117-141) is applied
    against a moving measurement model and diverges; a frozen world point
    makes z = h(poses; f) a fixed function across iterations."""
    k, m, _ = obs.shape
    dtype = cov.dtype
    d = cov.shape[0]
    g_vec = jnp.asarray(GRAVITY, dtype)

    def one_track(obs_k, mask_k, w_k):
        n_obs = jnp.sum(mask_k)
        enough = n_obs >= 2
        if fixed_world is None:
            ivd, anchor = triangulation.triangulate_gn(
                obs_k, mask_k, q_arr, p_arr, max_iter=max_iter, term=term
            )
            g_p_f = triangulation.ivd_to_world(ivd, q_arr[anchor], p_arr[anchor])
        else:
            ivd = jnp.zeros((3,), dtype)
            anchor = jnp.asarray(0, jnp.int32)
            g_p_f = w_k
        res, j_pos, j_att, hf, finite = _obs_jacobians(
            g_p_f, obs_k, mask_k, q_arr, p_arr, g_vec, oc=oc
        )
        h_j = _assemble_h(j_pos, j_att, m, n_features, dtype)
        hf_flat = hf.reshape(2 * m, 3)
        res_flat = res.reshape(2 * m)
        h0, res0, _, _ = linalg.nullspace_project(hf_flat, h_j, res_flat)

        # chi2(2m-3, 0.95) gate on the whitened projected system
        h0w = h0 / sigma_img
        res0w = res0 / sigma_img
        gamma = linalg.mahalanobis_gamma(cov, h0w, res0w)
        dof = 2 * n_obs - 3
        inlier = chi2_gate(gamma, dof, 0.95, 2 * m)
        valid = enough & finite & jnp.isfinite(gamma)

        keep = inlier & valid
        h0 = jnp.where(keep, h0, 0.0)
        res0 = jnp.where(keep, res0, 0.0)
        return h0, res0, ivd, anchor, g_p_f, inlier & valid, valid

    w_in = jnp.zeros((k, 3), dtype) if fixed_world is None else fixed_world
    h0, res0, ivd, anchor, world, inlier, valid = jax.vmap(one_track)(
        obs, mask, w_in
    )

    rows = k * (2 * m - 3)
    update = UpdateRows(
        jac=h0.reshape(rows, d),
        res=res0.reshape(rows),
        noise_std=jnp.full((rows,), sigma_img, dtype),
    )
    info = MsckfTrackInfo(
        ivd=ivd, anchor=anchor, world=world, inlier=inlier, valid=valid
    )
    return update, info
