"""Vision-state bookkeeping on the EKF state as pure tensor ops.

Behavioral spec: reference ``src/x/vio/state_manager.cpp``:
  * lost-SLAM-feature removal with covariance row/col excision
    (``state_manager.cpp:48-112``) -> compaction permutation gather
  * anchor reparametrization of features anchored to the oldest pose
    (Li RSS'12 eq. 38 + covariance Jacobian, ``state_manager.cpp:351-482``)
  * sliding-window shift with the sparse left/right multipliers
    (``state_manager.cpp:484-537``) -> index-map gather + zeroing
  * pose augmentation Jacobian incl. IMU-camera extrinsics
    (``state_manager.cpp:273-349``)
  * MSCKF-SLAM feature init (Li 2012 H2^-1-based mean/cov insertion,
    ``state_manager.cpp:151-174``) and standard SLAM init (Civera
    inverse-depth prior, ``state_manager.cpp:176-198``)

Deviation (documented): the reference seeds unfilled window/feature slots
with sigma^2 priors that its first augmentation Jacobian immediately wipes
(``state_manager.cpp:286-292``, the not-filled-before zero-base case). We
initialize those covariance blocks to zero instead; the post-first-augment
state is identical.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ekf.state import CoreState, StateDims, VisionState, camera_orientation, camera_position
from ..ops import lie
from ..ops.linalg import highprec


def _full_index_map(dims: StateDims, pose_map=None, feat_map=None):
    """Build a D-index gather map from per-pose and per-feature slot maps.

    pose_map/feat_map: (M,)/(N,) int arrays, entry = source slot (or -1 to
    zero the target slot). Returns (idx (D,), zero_mask (D,)).
    """
    m, n = dims.n_poses, dims.n_features
    if pose_map is None:
        pose_map = jnp.arange(m)
    if feat_map is None:
        feat_map = jnp.arange(n)
    core = jnp.arange(15)
    off = jnp.arange(3)

    def expand(base, mp):
        src = base + 3 * jnp.maximum(mp, 0)[:, None] + off[None, :]
        return src.reshape(-1), (mp < 0).repeat(3)

    pos_idx, pos_zero = expand(15, pose_map)
    att_idx, att_zero = expand(15 + 3 * m, pose_map)
    feat_idx, feat_zero = expand(15 + 6 * m, feat_map)
    idx = jnp.concatenate([core, pos_idx, att_idx, feat_idx])
    zero = jnp.concatenate([jnp.zeros(15, bool), pos_zero, att_zero, feat_zero])
    return idx, zero


def _permute_cov(cov, idx, zero):
    out = cov[idx][:, idx]
    out = jnp.where(zero[:, None] | zero[None, :], 0.0, out)
    return out


def _perm_matrix(idx, zero, d, dtype):
    """The (D, D) matrix equivalent of :func:`_permute_cov`:
    ``P @ cov @ P.T == _permute_cov(cov, idx, zero)``. One-hot rows keep the
    permutation exact in f32 and a plain batched matmul (a batched gather
    of a 150x150 covariance lowers to serialized dynamic-slices)."""
    p = (idx[:, None] == jnp.arange(d)[None, :]).astype(dtype)
    return jnp.where(zero[:, None], jnp.zeros((), dtype), p)


# ---------------------------------------------------------------------------
# lost feature removal
# ---------------------------------------------------------------------------


def _remove_features_t(
    dims: StateDims, vision: VisionState, lost: jnp.ndarray, dtype
):
    """Vision-state part of lost-feature excision + its (D, D) covariance
    transform. Returns (vision, t, perm, n_keep)."""
    n = dims.n_features
    active = jnp.arange(n) < vision.n_valid_features
    keep = active & ~lost
    from .track_manager import stable_partition

    perm = stable_partition(keep)
    n_keep = jnp.sum(keep)
    keep_sorted = jnp.arange(n) < n_keep

    f_arr = jnp.where(keep_sorted[:, None], vision.f_arr[perm], 0.0)
    anchor = jnp.where(keep_sorted, vision.anchor_idx[perm], -1)
    feat_map = jnp.where(keep_sorted, perm, -1)
    idx, zero = _full_index_map(dims, feat_map=feat_map)
    t = _perm_matrix(idx, zero, dims.d, dtype)

    vision = dataclasses.replace(
        vision, f_arr=f_arr, anchor_idx=anchor, n_valid_features=n_keep.astype(jnp.int32)
    )
    return vision, t, perm, n_keep


@highprec
def remove_features(
    dims: StateDims, vision: VisionState, cov: jnp.ndarray, lost: jnp.ndarray
) -> Tuple[VisionState, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Excise lost SLAM features; compact survivors to the front.

    Returns (vision, cov, perm, n_keep) — apply ``perm``/``n_keep`` to the
    track slots too so slot alignment is preserved.
    """
    vision, t, perm, n_keep = _remove_features_t(dims, vision, lost, cov.dtype)
    cov = t @ cov @ t.T
    return vision, cov, perm, n_keep


# ---------------------------------------------------------------------------
# reparametrization (Li RSS'12 eq. 38)
# ---------------------------------------------------------------------------


def _reparametrize_t(dims: StateDims, vision: VisionState, dtype):
    """Vision-state part of anchor reparametrization + its (D, D) Jacobian.
    Returns (vision, jmat)."""
    m, n = dims.n_poses, dims.n_features
    d = dims.d

    active = jnp.arange(n) < vision.n_valid_features
    needs = active & (vision.anchor_idx == 0)

    q_old = vision.q_arr[0]
    p_old = vision.p_arr[0]
    q_new = vision.q_arr[m - 1]
    p_new = vision.p_arr[m - 1]
    r_old = lie.quat_to_rot(q_old)
    r_new = lie.quat_to_rot(q_new)

    def one(f, j):
        alpha_o, beta_o, rho_o = f[0], f[1], f[2]
        rho_safe = jnp.where(jnp.abs(rho_o) > 1e-12, rho_o, 1.0)
        bear_o = jnp.stack([alpha_o, beta_o, jnp.ones((), dtype)])
        new_params = r_new.T @ (-p_new + p_old + (r_old @ bear_o) / rho_safe)
        z = jnp.where(jnp.abs(new_params[2]) > 1e-12, new_params[2], 1.0)
        rho_n = 1.0 / z
        alpha_n = new_params[0] * rho_n
        beta_n = new_params[1] * rho_n
        f_new = jnp.stack([alpha_n, beta_n, rho_n])

        # covariance Jacobian rows (state_manager.cpp:404-476)
        j_a_att_old = -1.0 / rho_safe * r_new.T @ r_old @ lie.skew(bear_o)
        j_a_att_new = lie.skew(new_params)
        j_a_pos_old = r_new.T
        j_a_pos_new = -r_new.T
        one = jnp.ones((), dtype)
        zero = jnp.zeros((), dtype)
        # stacked construction: .at[i, j].set on tiny matrices inside this
        # vmapped body lowers to full-batch dynamic-update-slices (~0.2
        # ms/frame each at 128 agents in the device trace)
        mat_o = jnp.stack(
            [
                jnp.stack([one, zero, -alpha_o / rho_safe]),
                jnp.stack([zero, one, -beta_o / rho_safe]),
                jnp.stack([zero, zero, -1.0 / rho_safe]),
            ]
        )
        j_feat_old = (1.0 / rho_safe) * r_new.T @ r_old @ mat_o

        # one concatenated materialization (old pose = window slot 0, new
        # pose = slot m-1); the own-feature block lands via a one-hot
        # matmul — a batch-varying dynamic_update_slice would serialize
        # under vmap
        z_mid = jnp.zeros((3, 3 * (m - 2)), dtype)
        a_j = jnp.concatenate(
            [
                jnp.zeros((3, 15), dtype),
                j_a_pos_old, z_mid, j_a_pos_new,
                j_a_att_old, z_mid, j_a_att_new,
                jnp.zeros((3, 3 * n), dtype),
            ],
            axis=1,
        )
        cols = jnp.arange(d, dtype=jnp.int32)
        tgt = jnp.int32(15 + 6 * m) + 3 * j + jnp.arange(3, dtype=jnp.int32)
        sel = (cols[None, :] == tgt[:, None]).astype(dtype)
        a_j = a_j + j_feat_old @ sel

        mat_n = jnp.stack(
            [
                jnp.stack([one, zero, -alpha_n]),
                jnp.stack([zero, one, -beta_n]),
                jnp.stack([zero, zero, -rho_n]),
            ]
        )
        rows = rho_n * mat_n @ a_j  # (3, D)
        return f_new, rows

    f_new_all, rows_all = jax.vmap(one)(vision.f_arr, jnp.arange(n, dtype=jnp.int32))

    f_arr = jnp.where(needs[:, None], f_new_all, vision.f_arr)
    anchor = jnp.where(needs, m - 1, vision.anchor_idx)

    # J = identity with replaced feature rows where needed
    jmat = jnp.eye(d, dtype=dtype)
    feat_rows = jmat[15 + 6 * m :].reshape(n, 3, d)
    feat_rows = jnp.where(needs[:, None, None], rows_all, feat_rows)
    jmat = jmat.at[15 + 6 * m :].set(feat_rows.reshape(3 * n, d))

    vision = dataclasses.replace(vision, f_arr=f_arr, anchor_idx=anchor)
    return vision, jmat


@highprec
def reparametrize_features(
    dims: StateDims, vision: VisionState, cov: jnp.ndarray
) -> Tuple[VisionState, jnp.ndarray]:
    """Re-anchor features anchored at window slot 0 to the newest slot M-1
    (runs right before the window slides)."""
    vision, jmat = _reparametrize_t(dims, vision, cov.dtype)
    cov = jmat @ cov @ jmat.T
    return vision, cov


# ---------------------------------------------------------------------------
# window slide
# ---------------------------------------------------------------------------


def _slide_t(dims: StateDims, vision: VisionState, dtype):
    """Vision-state part of the window slide + its (D, D) transform (a
    constant shift-and-zero permutation). Returns (vision, t)."""
    m = dims.n_poses
    pose_map = jnp.concatenate([jnp.arange(1, m), jnp.array([-1])])
    idx, zero = _full_index_map(dims, pose_map=pose_map)
    t = _perm_matrix(idx, zero, dims.d, dtype)

    p_arr = jnp.concatenate([vision.p_arr[1:], jnp.zeros_like(vision.p_arr[:1])])
    q_id = jnp.zeros_like(vision.q_arr[:1]).at[0, 3].set(1.0)
    q_arr = jnp.concatenate([vision.q_arr[1:], q_id])
    active = jnp.arange(dims.n_features) < vision.n_valid_features
    anchor = jnp.where(active, vision.anchor_idx - 1, vision.anchor_idx)
    # right-aligned window: sliding an *invalid* leading slot out keeps the
    # valid count; sliding a valid one (full window) drops it by one
    n_valid = jnp.where(
        vision.n_valid_poses == m, vision.n_valid_poses - 1, vision.n_valid_poses
    )
    vision = dataclasses.replace(
        vision,
        p_arr=p_arr,
        q_arr=q_arr,
        anchor_idx=anchor,
        n_valid_poses=n_valid,
    )
    return vision, t


@highprec
def slide_window(
    dims: StateDims, vision: VisionState, cov: jnp.ndarray
) -> Tuple[VisionState, jnp.ndarray]:
    vision, t = _slide_t(dims, vision, cov.dtype)
    cov = t @ cov @ t.T
    return vision, cov


# ---------------------------------------------------------------------------
# pose augmentation
# ---------------------------------------------------------------------------


def _augment_t(
    dims: StateDims,
    core: CoreState,
    vision: VisionState,
    q_ic: jnp.ndarray,
    p_ic: jnp.ndarray,
    dtype,
):
    """Vision-state part of pose augmentation + its (D, D) Jacobian.
    Returns (vision, jmat)."""
    m = dims.n_poses
    d = dims.d
    pos = m - 1  # static

    cam_q = camera_orientation(core, q_ic)
    cam_p = camera_position(core, p_ic)
    p_arr = vision.p_arr.at[pos].set(cam_p)
    q_arr = vision.q_arr.at[pos].set(cam_q)

    row_p = 15 + 3 * pos
    row_q = 15 + 3 * m + 3 * pos
    jmat = jnp.eye(d, dtype=dtype)
    jmat = jmat.at[row_p : row_p + 3, :].set(0.0)
    jmat = jmat.at[row_q : row_q + 3, :].set(0.0)
    # d(cam pos err)/d(imu pos err) = I ; /d(imu att err) = -C(q) [p_ic]x
    jmat = jmat.at[row_p : row_p + 3, 0:3].set(jnp.eye(3, dtype=dtype))
    jmat = jmat.at[row_p : row_p + 3, 6:9].set(
        -lie.quat_to_rot(core.q) @ lie.skew(p_ic)
    )
    # d(cam att err)/d(imu att err) = C(q_ic)^T
    jmat = jmat.at[row_q : row_q + 3, 6:9].set(lie.quat_to_rot(q_ic).T)

    vision = dataclasses.replace(
        vision,
        p_arr=p_arr,
        q_arr=q_arr,
        n_valid_poses=jnp.minimum(vision.n_valid_poses + 1, m),
    )
    return vision, jmat


@highprec
def augment_pose(
    dims: StateDims,
    core: CoreState,
    vision: VisionState,
    cov: jnp.ndarray,
    q_ic: jnp.ndarray,
    p_ic: jnp.ndarray,
) -> Tuple[VisionState, jnp.ndarray]:
    """Clone the current camera pose into window slot M-1 (the window is
    right-aligned; the slide has already vacated and zeroed that slot).
    The sandwich fills the (previously zeroed) new-pose rows/cols from the
    core covariance."""
    vision, jmat = _augment_t(dims, core, vision, q_ic, p_ic, cov.dtype)
    cov = jmat @ cov @ jmat.T
    return vision, cov


# ---------------------------------------------------------------------------
# manage = remove + (reparam + slide if full) + augment
# ---------------------------------------------------------------------------


@highprec
def manage(
    dims: StateDims,
    core: CoreState,
    vision: VisionState,
    cov: jnp.ndarray,
    lost: jnp.ndarray,
    q_ic: jnp.ndarray,
    p_ic: jnp.ndarray,
):
    """Reference ``StateManager::manage`` (state_manager.cpp:31-145).

    Returns (vision, cov, perm, n_keep).

    The four covariance operations (excision, reparametrization Jacobian,
    window-slide permutation, augmentation Jacobian) are composed into ONE
    (D, D) transform and applied as a single sandwich ``T @ cov @ T.T`` —
    algebraically identical to the sequential sandwiches, ~3x fewer big
    matmuls and no serialized gathers.
    """
    dtype = cov.dtype
    # right-aligned window: reparametrize + slide run unconditionally;
    # during warmup no feature is anchored at slot 0 (invalid pose) so the
    # reparametrization is the identity and the slide shifts an empty slot.
    vision, t_rm, perm, n_keep = _remove_features_t(dims, vision, lost, dtype)
    vision, j_rep = _reparametrize_t(dims, vision, dtype)
    vision, t_sl = _slide_t(dims, vision, dtype)
    vision, j_aug = _augment_t(dims, core, vision, q_ic, p_ic, dtype)
    t = j_aug @ (t_sl @ (j_rep @ t_rm))
    cov = t @ cov @ t.T
    return vision, cov, perm, n_keep


# ---------------------------------------------------------------------------
# feature initialization
# ---------------------------------------------------------------------------


@highprec
def init_new_features(
    dims: StateDims,
    vision: VisionState,
    cov: jnp.ndarray,
    is_msckf: jnp.ndarray,  # (K,) MSCKF-SLAM vs standard inverse-depth init
    h1: jnp.ndarray,  # (K, 3, D) MSCKF-SLAM column-space Jacobian
    h2: jnp.ndarray,  # (K, 3, 3)
    r1: jnp.ndarray,  # (K, 3)
    features: jnp.ndarray,  # (K, 3) triangulated inverse depth
    z_obs: jnp.ndarray,  # (K, 2) last observation (standard-init seed)
    accept: jnp.ndarray,  # (K,) bool
    correction: jnp.ndarray,  # (D,)
    sigma_img: float,
    rho_0: float,
    sigma_rho_0: float,
):
    """Batched insertion of ALL accepted new features in candidate order.

    One covariance sandwich replaces the reference's sequential inserts
    (``state_manager.cpp:151-198``): with T = I whose new-slot rows are
    G_i = -H2^-1 H1 (MSCKF-SLAM) or 0 (standard), the sequential result is
    exactly  T P T^T + blkdiag(W_i)  because H1 has zero columns at every
    feature slot, so later inserts' cross-covariance against earlier ones
    is G_j P G_i^T — the (slot_j, slot_i) block of the sandwich. Verified
    against the sequential oracle in tests/test_feature_init.py.

    Candidate order also matches ``track_manager.insert_new_slam_tracks``
    slot assignment (type-segregated sequential insertion would not).
    """
    m, n = dims.n_poses, dims.n_features
    d = dims.d
    dtype = cov.dtype
    var_img = sigma_img * sigma_img
    k = accept.shape[0]

    order = jnp.cumsum(accept) - 1
    slot = vision.n_valid_features + order
    ok = accept & (slot < n)
    n_ins = jnp.sum(ok).astype(jnp.int32)

    # per-candidate insert quantities
    from ..ops.linalg import inv3

    eye3 = jnp.eye(3, dtype=dtype)
    h2_safe = jnp.where(is_msckf[:, None, None], h2, eye3)
    h2_inv = inv3(h2_safe)
    g_ms = -jnp.einsum("kab,kbd->kad", h2_inv, h1)  # (K, 3, D)
    f_ms = (
        features
        + jnp.einsum("kad,d->ka", g_ms, correction)
        + jnp.einsum("kab,kb->ka", h2_inv, r1)
    )
    w_ms = var_img * jnp.einsum("kab,kcb->kac", h2_inv, h2_inv)

    f_std = jnp.concatenate(
        [z_obs, jnp.full((k, 1), rho_0, dtype)], axis=-1
    )
    w_std = jnp.broadcast_to(
        jnp.diag(jnp.asarray([var_img, var_img, sigma_rho_0 * sigma_rho_0], dtype)),
        (k, 3, 3),
    )

    g_rows = jnp.where(is_msckf[:, None, None], g_ms, 0.0)
    w_blk = jnp.where(is_msckf[:, None, None], w_ms, w_std)
    f_new = jnp.where(is_msckf[:, None], f_ms, f_std)

    # feature slot -> candidate index (-1 = untouched slot)
    cand_by_slot = jnp.full((n,), -1, jnp.int32)
    cand_by_slot = cand_by_slot.at[jnp.where(ok, slot, n)].set(
        jnp.arange(k, dtype=jnp.int32), mode="drop"
    )
    is_new = cand_by_slot >= 0
    safe_cand = jnp.maximum(cand_by_slot, 0)

    t = jnp.eye(d, dtype=dtype)
    feat_rows = t[15 + 6 * m :].reshape(n, 3, d)
    feat_rows = jnp.where(is_new[:, None, None], g_rows[safe_cand], feat_rows)
    t = t.at[15 + 6 * m :].set(feat_rows.reshape(3 * n, d))

    cov1 = t @ cov @ t.T
    w_slot = jnp.where(is_new[:, None, None], w_blk[safe_cand], 0.0)
    rng_n = jnp.arange(n)
    w_big = (
        jnp.zeros((n, 3, n, 3), dtype)
        .at[rng_n, :, rng_n, :]
        .set(w_slot)
        .reshape(3 * n, 3 * n)
    )
    cov1 = cov1.at[15 + 6 * m :, 15 + 6 * m :].add(w_big)

    f_arr = jnp.where(is_new[:, None], f_new[safe_cand], vision.f_arr)
    anchor = jnp.where(is_new, jnp.int32(m - 1), vision.anchor_idx)
    vision = dataclasses.replace(
        vision,
        f_arr=f_arr,
        anchor_idx=anchor,
        n_valid_features=vision.n_valid_features + n_ins,
    )
    return vision, cov1


@highprec
def init_msckf_slam_features(
    dims: StateDims,
    vision: VisionState,
    cov: jnp.ndarray,
    h1: jnp.ndarray,  # (K, 3, D)
    h2: jnp.ndarray,  # (K, 3, 3)
    r1: jnp.ndarray,  # (K, 3)
    features: jnp.ndarray,  # (K, 3) triangulated inverse depth
    accept: jnp.ndarray,  # (K,) bool
    correction: jnp.ndarray,  # (D,) total update correction
    sigma_img: float,
):
    """Sequentially insert MSCKF-SLAM features (Li 2012;
    ``state_manager.cpp:151-174``). Sequential so later features pick up
    cross-covariance with earlier ones, like the reference."""
    m, n = dims.n_poses, dims.n_features
    d = dims.d
    dtype = cov.dtype
    var_img = sigma_img * sigma_img
    k = accept.shape[0]

    def body(carry, i):
        vision, cov = carry
        can = accept[i] & (vision.n_valid_features < n)

        def do(args):
            vision, cov = args
            slot = vision.n_valid_features
            h2_inv = jnp.linalg.inv(h2[i])
            h2_inv_h1 = h2_inv @ h1[i]
            f_new = features[i] - h2_inv_h1 @ correction + h2_inv @ r1[i]
            cross = -h2_inv_h1 @ cov  # (3, D)
            diag = h2_inv_h1 @ cov @ h2_inv_h1.T + var_img * (h2_inv @ h2_inv.T)

            row = 15 + 6 * m + 3 * slot
            cov = jax.lax.dynamic_update_slice(cov, cross, (row, jnp.int32(0)))
            cov = jax.lax.dynamic_update_slice(cov, cross.T, (jnp.int32(0), row))
            cov = jax.lax.dynamic_update_slice(cov, diag, (row, row))

            vision = dataclasses.replace(
                vision,
                f_arr=vision.f_arr.at[slot].set(f_new),
                anchor_idx=vision.anchor_idx.at[slot].set(
                    jnp.int32(dims.n_poses - 1)  # anchored at the current pose
                ),
                n_valid_features=vision.n_valid_features + 1,
            )
            return vision, cov

        return jax.lax.cond(can, do, lambda a: a, (vision, cov)), None

    (vision, cov), _ = jax.lax.scan(body, (vision, cov), jnp.arange(k))
    return vision, cov


@highprec
def init_standard_slam_features(
    dims: StateDims,
    vision: VisionState,
    cov: jnp.ndarray,
    z_obs: jnp.ndarray,  # (K, 2) last observation (alpha, beta seed)
    accept: jnp.ndarray,  # (K,)
    rho_0: float,
    sigma_img: float,
    sigma_rho_0: float,
):
    """Civera-style inverse-depth prior init (``state_manager.cpp:176-198``,
    ``slam_update.cpp:216-242``)."""
    m, n = dims.n_poses, dims.n_features
    dtype = cov.dtype
    var_img = sigma_img * sigma_img
    var_rho = sigma_rho_0 * sigma_rho_0
    k = accept.shape[0]
    diag = jnp.diag(jnp.asarray([var_img, var_img, var_rho], dtype))

    def body(carry, i):
        vision, cov = carry
        can = accept[i] & (vision.n_valid_features < n)

        def do(args):
            vision, cov = args
            slot = vision.n_valid_features
            f_new = jnp.concatenate([z_obs[i], jnp.asarray([rho_0], dtype)])
            row = 15 + 6 * m + 3 * slot
            zero3 = jnp.zeros((3, cov.shape[0]), dtype)
            cov = jax.lax.dynamic_update_slice(cov, zero3, (row, jnp.int32(0)))
            cov = jax.lax.dynamic_update_slice(cov, zero3.T, (jnp.int32(0), row))
            cov = jax.lax.dynamic_update_slice(cov, diag, (row, row))
            vision = dataclasses.replace(
                vision,
                f_arr=vision.f_arr.at[slot].set(f_new),
                anchor_idx=vision.anchor_idx.at[slot].set(
                    jnp.int32(dims.n_poses - 1)  # anchored at the current pose
                ),
                n_valid_features=vision.n_valid_features + 1,
            )
            return vision, cov

        return jax.lax.cond(can, do, lambda a: a, (vision, cov)), None

    (vision, cov), _ = jax.lax.scan(body, (vision, cov), jnp.arange(k))
    return vision, cov
