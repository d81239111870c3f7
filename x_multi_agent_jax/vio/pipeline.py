"""The fused per-frame visual update program.

This is the fixed-shape re-design of ``Updater::update`` (reference
``updater.cpp:39-115``) + ``VioUpdater`` (``vio_updater.cpp``): one jitted,
fixed-shape program per camera frame that runs

  track classification -> short-MSCKF update -> state management
  (remove/reparametrize/slide/augment) -> [IEKF x iekf_iter] stacked
  MSCKF + MSCKF-SLAM + SLAM + range + solar rows -> whitened QR compression
  -> Kalman update -> feature initialization

Everything is masked/fixed-budget; gated-out rows are zeros and provably
do not affect the update (see ops/linalg.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ekf.state import (
    CoreState,
    StateDims,
    VisionState,
    camera_orientation,
    camera_position,
    correct_core,
    correct_vision,
)
from ..ops import linalg
from ..ops.triangulation import ivd_to_world
from . import state_manager as sm
from . import track_manager as tm
from .updates import msckf, msckf_slam, range as range_upd, slam, solar


class VioConfig(NamedTuple):
    """Static VIO configuration (hashable; reference ``vio/types.h:33-189``
    defaults)."""

    dims: StateDims = StateDims()
    tracks: tm.TrackDims = tm.TrackDims()
    q_ic: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    p_ic: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sigma_img: float = 0.005  # normalized-coordinate image noise std
    sigma_range: float = 0.05
    rho_0: float = 0.5
    sigma_rho_0: float = 0.25
    min_track_length: int = 15
    iekf_iter: int = 1
    # GN-triangulation iteration cap. The reference default is 10 with the
    # same early-termination test (msckf_update.h:93-96); measured
    # convergence on sim data is 2-4 steps, and each unrolled step is ~200
    # sequential HLOs in every triangulating builder, so 5 halves the
    # dominant sequential-op chain of the stacked update at no measured
    # accuracy cost (the termination flag freezes converged tracks).
    tri_max_iter: int = 5
    msckf_baseline_x_n: float = 0.02
    msckf_baseline_y_n: float = 0.02
    # Hesch observability-constrained projection in MSCKF rows
    # (msckf_update.cpp:393-406). True = reference parity. On clean
    # synthetic data it lets yaw random-walk (by design); turning it off
    # tightens ATE there.
    obs_constrained: bool = True
    # Static sensor gates: deployments without an LRF / sun sensor compile
    # the facet search + range/solar row builders out of the per-frame
    # program entirely (the reference's runtime activation flags,
    # vio.cpp:343-370, made static for XLA). Leave True to accept
    # measurements through FrameMeasurement.range_active / sun_active.
    enable_range: bool = True
    enable_sun: bool = True
    # Merge the short-MSCKF rows into the main stacked update instead of a
    # separate pre-manage update. The reference runs shorts against the
    # PRE-slide pose list (updater.cpp:52-75) because its window has
    # already been slid by preProcess; with the merge, short observations
    # are reindexed across the slide (obs at the evicted pose 0 is
    # dropped — shorts are < M frames long, so only a rare long dead
    # track loses one observation) and ride the same GN chain, nullspace
    # projection, gate and Kalman apply as the MSCKF rows. Saves a full
    # extra innovation solve + covariance update per frame (~3 ms at 128
    # agents, measured); the replay-level regression gate is the bench's
    # trajectory/NEES asserts + tests/test_vio_e2e.
    merge_short_into_stack: bool = True


class FrameMeasurement(NamedTuple):
    """Per-frame inputs to the visual update (fixed shapes)."""

    matches: tm.Matches
    # range (LRF) measurement; active if timestamp-like flag set. The facet
    # of SLAM features is selected on-device (range_facet.py).
    range_value: jnp.ndarray  # scalar
    range_img_pt: jnp.ndarray  # (2,) normalized LRF image point
    range_active: jnp.ndarray  # bool
    # sun sensor
    sun_angles: jnp.ndarray  # (2,)
    sun_active: jnp.ndarray  # bool

    @staticmethod
    def from_matches(cfg: VioConfig, matches: tm.Matches) -> "FrameMeasurement":
        dtype = matches.cur_pt.dtype
        return FrameMeasurement(
            matches=matches,
            range_value=jnp.zeros((), dtype),
            range_img_pt=jnp.zeros((2,), dtype),
            range_active=jnp.asarray(False),
            sun_angles=jnp.zeros((2,), dtype),
            sun_active=jnp.asarray(False),
        )


class FrameDebug(NamedTuple):
    """Per-frame observability payload (reference GUI accessors
    ``vio.cpp:328-341`` + the debug-image data of ``track_manager.cpp:638-731``).

    All points are normalized undistorted coordinates (denormalize with the
    camera for pixel-space rendering, ``utils/render.py``).
    """

    msckf_cur: jnp.ndarray  # (Km, 2) last obs of each MSCKF track
    msckf_inlier: jnp.ndarray  # (Km,) passed the chi2 gate
    msckf_valid: jnp.ndarray  # (Km,)
    short_cur: jnp.ndarray  # (Ks, 2)
    short_valid: jnp.ndarray  # (Ks,)
    slam_cur: jnp.ndarray  # (N, 2) current obs of SLAM features
    slam_valid: jnp.ndarray  # (N,)
    new_cur: jnp.ndarray  # (Kn, 2)
    new_valid: jnp.ndarray  # (Kn,)
    new_is_msckf: jnp.ndarray  # (Kn,)
    opp_cur: jnp.ndarray  # (Ko, 2) opportunistic pool current obs
    opp_valid: jnp.ndarray  # (Ko,)
    slam_cartesian: jnp.ndarray  # (N, 3) world-frame SLAM landmarks
    slam_cart_valid: jnp.ndarray  # (N,)
    facet_ids: jnp.ndarray  # (3,) SLAM indices of the LRF facet
    facet_found: jnp.ndarray  # bool

    @staticmethod
    def zero(cfg: "VioConfig", dtype=jnp.float32) -> "FrameDebug":
        t, n = cfg.tracks, cfg.dims.n_features
        return FrameDebug(
            msckf_cur=jnp.zeros((t.n_msckf, 2), dtype),
            msckf_inlier=jnp.zeros((t.n_msckf,), bool),
            msckf_valid=jnp.zeros((t.n_msckf,), bool),
            short_cur=jnp.zeros((t.n_short, 2), dtype),
            short_valid=jnp.zeros((t.n_short,), bool),
            slam_cur=jnp.zeros((n, 2), dtype),
            slam_valid=jnp.zeros((n,), bool),
            new_cur=jnp.zeros((t.n_new_slam, 2), dtype),
            new_valid=jnp.zeros((t.n_new_slam,), bool),
            new_is_msckf=jnp.zeros((t.n_new_slam,), bool),
            opp_cur=jnp.zeros((t.n_opp, 2), dtype),
            opp_valid=jnp.zeros((t.n_opp,), bool),
            slam_cartesian=jnp.zeros((n, 3), dtype),
            slam_cart_valid=jnp.zeros((n,), bool),
            facet_ids=jnp.full((3,), -1, jnp.int32),
            facet_found=jnp.asarray(False),
        )


def _last_obs(obs: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Last masked observation of each (K, M, 2) track window."""
    m = obs.shape[1]
    pos = jnp.arange(m)
    last = jnp.max(jnp.where(mask, pos, -1), axis=1)
    return jnp.take_along_axis(obs, jnp.maximum(last, 0)[:, None, None], axis=1)[:, 0]


def _stack_rows(*rows_list):
    jac = jnp.concatenate([r.jac for r in rows_list], axis=0)
    res = jnp.concatenate([r.res for r in rows_list], axis=0)
    std = jnp.concatenate([r.noise_std for r in rows_list], axis=0)
    return jac, res, std


@linalg.highprec
def _apply_rows(cov, jac, res, std, correction_total, cov_update=True):
    """Whiten -> (QR-compress if strongly overdetermined) -> Kalman update.

    Compression threshold is 2D, not D+1: the Gram/Cholesky compression
    costs a batched (D+1)-Cholesky factorization call, while the direct
    S-form Kalman update scales as the row count's square in plain
    matmuls — for row counts up to ~2D the direct form is cheaper (the
    short-MSCKF stack lands here)."""
    d = cov.shape[0]
    hw, rw = linalg.whiten(jac, res, std)
    if jac.shape[0] > 2 * d:
        hw, rw = linalg.qr_compress(jac, res, std)
    corr, cov1 = linalg.kalman_update(cov, hw, rw, correction_total)
    if not cov_update:
        cov1 = cov
    return corr, cov1


def visual_update(
    cfg: VioConfig,
    core: CoreState,
    vision: VisionState,
    cov: jnp.ndarray,
    slots: tm.TrackSlots,
    meas: FrameMeasurement,
    store=None,
    collab_cfg=None,
    return_debug: bool = False,
):
    """One full visual update at the measurement state.

    With ``store`` (a :class:`parallel.match_store.MatchStore`) and
    ``collab_cfg`` (any config carrying max_peers / sigma_landmark /
    ci_slam_w / ci_msckf_w), persistent cross-agent matches are upgraded
    and consumed inside the update (reference MULTI_UAV ``updateOppMatches``
    + joint-MSCKF / SLAM-SLAM / short-CI consumption).

    Returns (core, vision, cov, slots) or, with a store,
    (core, vision, cov, slots, store, n_collab_applied).
    """
    dims = cfg.dims
    m, n = dims.n_poses, dims.n_features
    d = dims.d
    dtype = cov.dtype
    q_ic = jnp.asarray(cfg.q_ic, dtype)
    p_ic = jnp.asarray(cfg.p_ic, dtype)

    # ---------------- 1. track classification (pre-slide window) ----------
    q_cur = camera_orientation(core, q_ic)
    slots, frame, slam_z = tm.manage_tracks(
        cfg.tracks,
        slots,
        meas.matches,
        vision.q_arr,
        q_cur,
        cfg.min_track_length,
        cfg.msckf_baseline_x_n,
        cfg.msckf_baseline_y_n,
        prev_pose_valid=vision.n_valid_poses >= 1,
    )

    # ---------------- 1b. persistent cross-agent match consumption --------
    n_collab = jnp.asarray(0, jnp.int32)
    work = None
    if store is not None:
        from ..parallel import match_store as ms_mod
        from .updates import msckf_multi, multi_slam

        store, work = ms_mod.update_and_harvest(
            store, slots, frame, collab_cfg.max_peers
        )
        # keep the original MSCKF rows for the joint fusion below (the
        # solo stack gets the matched rows masked out)
        joint_obs = frame.msckf_obs
        joint_mask = frame.msckf_mask
        # SLAM-SLAM upgrades: feature indices are pre-compaction here,
        # aligned with the current vision state (the reference applies
        # them in processOtherMeasurements, order-equivalent)
        if collab_cfg.use_stored_slam:
            (ss_own, ss_peer, ss_p, ss_q, ss_f, ss_a, ss_cov, ss_ok) = (
                ms_mod.gather_peer_slam(store, work)
            )
            core, vision, cov, n_ss, _ = multi_slam.apply_matches_pairs(
                dims, core, vision, cov, ss_p, ss_q, ss_f, ss_a, ss_cov,
                ss_own, ss_peer, ss_ok,
                collab_cfg.sigma_landmark, collab_cfg.ci_slam_w,
            )
            n_collab = n_collab + n_ss
        if collab_cfg.use_stored_shortci:
            # matched DEAD tracks: joint short-MSCKF CI against the
            # pre-slide pose list (the active opp_ids_ path,
            # track_manager.cpp:238-260 + updater.cpp:52-75); matched rows
            # leave the plain short update
            sj_p, sj_q, sj_cov, sj_obs, sj_mask = ms_mod.gather_peer_tracks(
                store, work.short_rows, work.short_matched
            )
            short_matched_any = work.short_matched.any(axis=1)
            core, vision, cov, n_sj = msckf_multi.apply_joint_msckf_ci_pairs(
                dims, core, vision, cov,
                frame.short_obs, frame.short_mask & short_matched_any[:, None],
                frame.short_valid & short_matched_any,
                sj_p, sj_q, sj_cov, sj_obs, sj_mask, work.short_matched,
                cfg.sigma_img, collab_cfg.ci_msckf_w, oc=cfg.obs_constrained,
            )
            n_collab = n_collab + n_sj
        else:
            short_matched_any = jnp.zeros_like(frame.short_valid)
        msckf_matched_any = (
            work.msckf_matched.any(axis=1)
            if collab_cfg.use_stored_msckf
            else jnp.zeros_like(frame.msckf_valid)
        )
        joint_valid = frame.msckf_valid & msckf_matched_any
        frame = dataclasses.replace(
            frame,
            short_valid=frame.short_valid & ~short_matched_any,
            short_mask=frame.short_mask & ~short_matched_any[:, None],
            # matched MSCKF tracks leave the solo stack (consumed jointly
            # after the stacked update, msckf_update.cpp MULTI_UAV branch)
            msckf_valid=frame.msckf_valid & ~msckf_matched_any,
            msckf_mask=frame.msckf_mask & ~msckf_matched_any[:, None],
        )

    # ---------------- 2. short-MSCKF update (pre-slide pose list) ---------
    if not cfg.merge_short_into_stack:
        short_rows, _ = msckf.build(
            frame.short_obs,
            frame.short_mask,
            vision.q_arr,
            vision.p_arr,
            cov,
            cfg.sigma_img,
            n,
            max_iter=cfg.tri_max_iter,
            oc=cfg.obs_constrained,
        )
        have_short = frame.short_valid.any()
        corr_short, cov = jax.lax.cond(
            have_short,
            lambda: _apply_rows(cov, *short_rows, jnp.zeros(d, dtype)),
            lambda: (jnp.zeros(d, dtype), cov),
        )
        core = correct_core(core, corr_short)
        vision = correct_vision(vision, corr_short, dims)

    # ---------------- 3. state management ---------------------------------
    vision, cov, perm, n_keep = sm.manage(
        dims, core, vision, cov, frame.lost_slam, q_ic, p_ic
    )
    slots = tm.apply_slam_compaction(slots, perm, n_keep)
    # compact the per-frame SLAM observation set the same way
    keep_sorted = jnp.arange(n) < n_keep
    slam_z = jnp.where(keep_sorted[:, None], slam_z[perm], 0.0)
    slam_has_obs = jnp.where(keep_sorted, frame.slam_has_obs[perm], False)
    slam_len = jnp.where(keep_sorted, slots.slam_length, 0)

    cur_pose_idx = m - 1  # static: the window is right-aligned

    # merged short rows: reindex the dead tracks' observations across the
    # slide (old window slot k+1 -> new slot k; see merge_short_into_stack)
    if cfg.merge_short_into_stack:
        sh_obs = jnp.concatenate(
            [frame.short_obs[:, 1:], jnp.zeros_like(frame.short_obs[:, :1])],
            axis=1,
        )
        sh_mask = jnp.concatenate(
            [frame.short_mask[:, 1:],
             jnp.zeros_like(frame.short_mask[:, :1])],
            axis=1,
        ) & frame.short_valid[:, None]
        stack_obs = jnp.concatenate([frame.msckf_obs, sh_obs], axis=0)
        stack_mask = jnp.concatenate([frame.msckf_mask, sh_mask], axis=0)
    else:
        stack_obs = frame.msckf_obs
        stack_mask = frame.msckf_mask
    k_stack = stack_obs.shape[0]

    # ---------------- 4. IEKF loop: stacked update -------------------------
    correction_total = jnp.zeros(d, dtype)
    ms_init = None
    ms_info = None
    facet_ids = facet_found = None
    new_mask_ms = frame.new_mask & frame.new_is_msckf[:, None]
    for it in range(cfg.iekf_iter):
        # IEKF iterations > 0 keep the it-0 measurement model FROZEN
        # (triangulated point, nullspace projector, Jacobians, gates) and
        # re-evaluate ONLY the residuals against the corrected window —
        # textbook iterated-EKF residual relinearization. Re-deriving the
        # model per iteration lets the re-triangulated feature absorb each
        # correction and rotates the retained measurement subspace against
        # the fixed prior (measured: iekf_iter=3 diverged 5x / drifted in
        # the linear-regime oracle before the freeze; test_iekf.py).
        if it == 0:
            # ONE batched GN-triangulation chain for both track families:
            # the unrolled 10-step GN refinement is ~4.8k sequential HLOs
            # per builder call, and under vmap its op count is independent
            # of the track count — so triangulating the MSCKF and
            # MSCKF-SLAM sets in separate builder calls doubles the
            # dominant sequential-small-op cost of the stacked update for
            # no reason. Both builders accept precomputed triangulations
            # (fixed_world / fixed_tri, the IEKF>0 path), so hoist one
            # concatenated call here. Bit-identical inputs to each
            # builder; reference runs the same GN per track set
            # (msckf_update.cpp:90-130, msckf_slam_update.cpp).
            from ..ops.triangulation import triangulate_gn

            k_ms = k_stack
            all_obs = jnp.concatenate([stack_obs, frame.new_obs], axis=0)
            all_mask = jnp.concatenate([stack_mask, new_mask_ms], axis=0)
            ivd_all, anchor_all = linalg.highprec(jax.vmap(
                lambda o, mk: triangulate_gn(
                    o, mk, vision.q_arr, vision.p_arr,
                    max_iter=cfg.tri_max_iter,
                )
            ))(all_obs, all_mask)
            # ^ highprec: triangulation error is NOT benign here — the
            # chain seeds MSCKF-SLAM feature inits (fixed_tri), and
            # reduced-mantissa DLT/GN on low-parallax image tracks
            # produces landmark inits bad enough to blow the f32
            # covariance up under image-path load
            world_ms = jax.vmap(
                lambda f, a: ivd_to_world(f, vision.q_arr[a], vision.p_arr[a])
            )(ivd_all[:k_ms], anchor_all[:k_ms])
            msckf_rows, ms_info = msckf.build(
                stack_obs, stack_mask, vision.q_arr,
                vision.p_arr, cov, cfg.sigma_img, n,
                oc=cfg.obs_constrained, fixed_world=world_ms,
            )
            mslam_rows, ms_init = msckf_slam.build(
                frame.new_obs, new_mask_ms, vision.q_arr, vision.p_arr,
                cov, cfg.sigma_img, n,
                fixed_tri=(ivd_all[k_ms:], anchor_all[k_ms:]),
            )
        else:
            msckf_rows, _ = msckf.build(
                stack_obs, stack_mask, vision.q_arr,
                vision.p_arr, cov, cfg.sigma_img, n,
                oc=cfg.obs_constrained, fixed_world=ms_info.world,
            )
            mslam_rows, ms_init = msckf_slam.build(
                frame.new_obs, new_mask_ms, vision.q_arr, vision.p_arr,
                cov, cfg.sigma_img, n,
                fixed_tri=(ms_init.features, ms_init.anchor),
            )
        slam_rows = slam.build(
            vision.f_arr, vision.anchor_idx, vision.q_arr, vision.p_arr,
            slam_z, slam_has_obs, jnp.minimum(slam_len, m), cov,
            cur_pose_idx, cfg.sigma_img,
        )
        rows_list = [msckf_rows, mslam_rows, slam_rows]
        if cfg.enable_range:
            # LRF facet: Delaunay-equivalent triangle of SLAM features
            # around the LRF image point (range_facet.py)
            from .range_facet import feature_triangle_at_point

            facet_ids, facet_found = feature_triangle_at_point(
                slam_z, slam_has_obs, meas.range_img_pt
            )
            lrf_rows = range_upd.build(
                meas.range_value, meas.range_img_pt, facet_ids,
                vision.f_arr, vision.anchor_idx, vision.q_arr, vision.p_arr,
                cov, cur_pose_idx, cfg.sigma_range,
                meas.range_active & facet_found,
            )
            rows_list.append(lrf_rows)
        else:
            facet_ids = jnp.full((3,), -1, jnp.int32)
            facet_found = jnp.asarray(False)
        if cfg.enable_sun:
            rows_list.append(solar.build(
                meas.sun_angles, core.q, cov, meas.sun_active,
            ))
        jac, res, std = _stack_rows(*rows_list)
        have_any = jnp.any(res != 0.0) | jnp.any(jac != 0.0)
        is_last = it == cfg.iekf_iter - 1

        def apply(args):
            cov_in, corr_tot = args
            corr, cov1 = _apply_rows(cov_in, jac, res, std, corr_tot, cov_update=is_last)
            return corr, cov1

        corr, cov = jax.lax.cond(
            have_any,
            apply,
            lambda a: (jnp.zeros(d, dtype), a[0]),
            (cov, correction_total),
        )
        core = correct_core(core, corr)
        vision = correct_vision(vision, corr, dims)
        correction_total = correction_total + corr
        correction_last = corr  # increment since the LAST build

    # ---------------- 4b. joint-MSCKF CI on stored matches -----------------
    if store is not None and collab_cfg.use_stored_msckf:
        from ..parallel import match_store as ms_mod
        from .updates import msckf_multi

        jm_p, jm_q, jm_cov, jm_obs, jm_mask = ms_mod.gather_peer_tracks(
            store, work.msckf_rows, work.msckf_matched
        )
        core, vision, cov, n_jm = msckf_multi.apply_joint_msckf_ci_pairs(
            dims, core, vision, cov,
            joint_obs, joint_mask & joint_valid[:, None], joint_valid,
            jm_p, jm_q, jm_cov, jm_obs, jm_mask, work.msckf_matched,
            cfg.sigma_img, collab_cfg.ci_msckf_w, oc=cfg.obs_constrained,
        )
        n_collab = n_collab + n_jm

    # ---------------- 5. feature initialization ---------------------------
    ms_finite = (
        jnp.isfinite(ms_init.h2).all(axis=(1, 2))
        & jnp.isfinite(ms_init.h1).all(axis=(1, 2))
        & jnp.isfinite(ms_init.features).all(axis=1)
    )
    accept_ms = frame.new_valid & frame.new_is_msckf & ms_finite
    accept_std = frame.new_valid & ~frame.new_is_msckf
    accepted = jnp.where(frame.new_is_msckf, accept_ms, accept_std)
    n_feat_before = vision.n_valid_features

    std_z = frame.new_obs[:, m - 1]
    vision, cov = sm.init_new_features(
        dims, vision, cov, frame.new_is_msckf,
        ms_init.h1, ms_init.h2, ms_init.r1, ms_init.features,
        # MSCKF-SLAM init (Li 2012): f = f_hat + H2^-1 (r1 - H1 dx) where
        # (h1, h2, r1) come from the LAST IEKF iteration's build, i.e. the
        # linearization at x_{n-1} — so dx is the LAST increment only.
        # Passing the accumulated total double-counts earlier iterations'
        # corrections into every initialized landmark (this made
        # iekf_iter=3 drift 5x worse than iekf_iter=1 before the fix;
        # identical for iekf_iter=1 where last == total).
        std_z, accepted, correction_last,
        cfg.sigma_img, cfg.rho_0, cfg.sigma_rho_0,
    )
    slots = tm.insert_new_slam_tracks(slots, frame, accepted, n_feat_before)

    out = (core, vision, cov, slots)
    if store is not None:
        out = out + (store, n_collab)
    if return_debug:
        cart = jax.vmap(
            lambda f, a: ivd_to_world(f, vision.q_arr[a], vision.p_arr[a])
        )(vision.f_arr, vision.anchor_idx)
        feat_alive = jnp.arange(n) < vision.n_valid_features
        debug = FrameDebug(
            msckf_cur=_last_obs(frame.msckf_obs, frame.msckf_mask),
            msckf_inlier=ms_info.inlier[: frame.msckf_obs.shape[0]]
            & frame.msckf_valid,
            msckf_valid=frame.msckf_valid,
            short_cur=_last_obs(frame.short_obs, frame.short_mask),
            short_valid=frame.short_valid,
            slam_cur=slam_z,
            slam_valid=slam_has_obs,
            new_cur=frame.new_obs[:, m - 1],
            new_valid=frame.new_valid,
            new_is_msckf=frame.new_is_msckf,
            opp_cur=slots.opp_obs[:, m - 1],
            opp_valid=slots.opp_mask[:, m - 1] & (slots.opp_id >= 0),
            slam_cartesian=cart,
            slam_cart_valid=feat_alive,
            facet_ids=facet_ids,
            facet_found=facet_found,
        )
        out = out + (debug,)
    return out
