"""Detect-track front-end (behavioral spec: reference
``src/x/vision/tracker.cpp``).

Per frame (``Tracker::track``, tracker.cpp:134-294):
  build pyramid -> pyramidal LK on existing features -> fundamental-matrix
  RANSAC outlier rejection -> (re)detect FAST features when below
  n_feat_min, suppressing neighborhoods of tracked features -> emit
  matches.

Fixed-shape redesign: features live in a fixed slot array with stable ids
(ids replace the reference's feature-equality match association); every
step is a masked tensor op; the whole frame is one jitted program.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..vio.track_manager import Matches
from . import camera as cam_mod
from . import fast, lk
from .image import build_pyramid


class TrackerParams(NamedTuple):
    budget: int = 200  # feature slots == match budget
    fast_threshold: float = 9.0  # fast_detection_delta
    non_max_supp: bool = True
    block_half_length: int = 20  # suppression neighborhood around tracks
    margin: int = 20  # detection border margin
    n_feat_min: int = 80  # re-detect below this count
    n_tiles_h: int = 4
    n_tiles_w: int = 4
    max_feat_per_tile: int = 40
    pyramid_depth: int = 1  # reference default pyramid_depth_=1
    win_half: int = 10  # LK window half-size ((2*10+1)^2 ~ win_size 21)
    lk_iters: int = 10
    lk_max_level: int = 2
    min_eig_thr: float = 1e-4
    ransac_threshold_px: float = 0.3  # outlier_param1
    # post-LK inlier rates are >0.9; 96 size-8 samples miss an all-inlier
    # draw with probability (1-0.9^8)^96 ~ 5e-24 — 200 was pure waste
    ransac_hypotheses: int = 96
    # MULTI_UAV: compute binary descriptors at tracked points each frame
    # (reference computes ORB during detection, tracker.cpp:440-478)
    compute_descriptors: bool = False


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
class TrackerState:
    pts: jnp.ndarray  # (F, 2) pixel coords (distorted) in the *last* frame
    ids: jnp.ndarray  # (F,) int32, -1 = free slot
    scores: jnp.ndarray  # (F,) FAST score at detection
    levels: jnp.ndarray  # (F,) int32 pyramid level at detection
    next_id: jnp.ndarray  # int32
    prev_img: jnp.ndarray  # (H, W) last frame (pyramid rebuilt per call)
    has_prev: jnp.ndarray  # bool

    @staticmethod
    def zero(params: TrackerParams, h: int, w: int, dtype=jnp.float32):
        f = params.budget
        return TrackerState(
            pts=jnp.zeros((f, 2), dtype),
            ids=jnp.full((f,), -1, jnp.int32),
            scores=jnp.zeros((f,), dtype),
            levels=jnp.zeros((f,), jnp.int32),
            next_id=jnp.asarray(0, jnp.int32),
            prev_img=jnp.zeros((h, w), dtype),
            has_prev=jnp.asarray(False),
        )


def _detect_new_batch(
    params: TrackerParams,
    pyramid,  # list of (A, h_l, w_l)
    existing_pts: jnp.ndarray,  # (A, F, 2)
    existing_valid: jnp.ndarray,  # (A, F)
):
    """FAST detection on EVERY pyramid level (reference
    ``getFASTFeaturesPyramid``, tracker.cpp:420-449: per-level cv::FAST,
    candidate coords scaled by 2^level back to base resolution), with
    suppression of existing-feature neighborhoods — batched over agents.

    Returns (xy (A,C,2) base-level coords, score (A,C), level (A,C),
    valid (A,C)) with candidates from all detected levels concatenated.
    Per-tile caps apply within each level; the global score-sorted append in
    :func:`track_frame_batch` enforces the overall budget (the reference
    enforces tile caps at append time across levels, tracker.cpp:592-620).
    """
    xys, scores, levels, valids = [], [], [], []
    # the reference pyramid holds pyramid_depth levels TOTAL (level 0 =
    # base image, tracker.cpp:400-418); default depth 1 detects base-only
    n_levels = min(params.pyramid_depth, len(pyramid))
    for l in range(n_levels):
        img_l = pyramid[l]
        # crop to tile-divisible dims (coarse levels may not divide evenly)
        lh = (img_l.shape[1] // params.n_tiles_h) * params.n_tiles_h
        lw = (img_l.shape[2] // params.n_tiles_w) * params.n_tiles_w
        xy_l, score_l, valid_l = fast.detect_batch(
            img_l[:, :lh, :lw], params.fast_threshold, params.n_tiles_h,
            params.n_tiles_w, params.max_feat_per_tile, params.non_max_supp,
        )
        xy_l = xy_l * (2.0 ** l)
        xys.append(xy_l)
        scores.append(score_l)
        levels.append(jnp.full(score_l.shape, l, jnp.int32))
        valids.append(valid_l)
    xy = jnp.concatenate(xys, axis=1)
    score = jnp.concatenate(scores, axis=1)
    level = jnp.concatenate(levels, axis=1)
    valid = jnp.concatenate(valids, axis=1)
    h, w = pyramid[0].shape[1:]
    return jax.vmap(
        lambda *a: _suppress(params, h, w, *a)
    )(xy, score, level, valid, existing_pts, existing_valid)


def _suppress(
    params: TrackerParams,
    h: int,
    w: int,
    xy: jnp.ndarray,
    score: jnp.ndarray,
    level: jnp.ndarray,
    valid: jnp.ndarray,
    existing_pts: jnp.ndarray,
    existing_valid: jnp.ndarray,
):
    """Per-agent candidate filtering: image margin, live-feature
    neighborhood suppression, cross-level dedup."""
    m = params.margin
    inb = (
        (xy[:, 0] >= m) & (xy[:, 0] < w - m) & (xy[:, 1] >= m) & (xy[:, 1] < h - m)
    )
    # suppress candidates inside the block around any live feature
    # (tracker.cpp:494-534 neighborhood mask)
    d = jnp.abs(xy[:, None, :] - existing_pts[None, :, :])  # (C, F, 2)
    near = (d[..., 0] <= params.block_half_length) & (
        d[..., 1] <= params.block_half_length
    )
    near_any = jnp.any(near & existing_valid[None, :], axis=1)
    # dedup across levels: a coarse-level candidate within the suppression
    # radius of a finer-level candidate with a higher score is dropped;
    # the suppressor must itself survive the in-bounds/near-existing
    # filters and actually outscore the coarse candidate
    keep = valid & inb & ~near_any
    cross = (
        (jnp.abs(xy[:, None, 0] - xy[None, :, 0]) <= params.block_half_length)
        & (jnp.abs(xy[:, None, 1] - xy[None, :, 1]) <= params.block_half_length)
        & (level[:, None] > level[None, :])
        & keep[None, :]
        & (score[None, :] >= score[:, None])
    )
    dup = jnp.any(cross, axis=1)
    return xy, score, level, keep & ~dup


def _track_core(
    params: TrackerParams,
    cam: cam_mod.Camera,
    state: TrackerState,
    img: jnp.ndarray,
    cur_pts: jnp.ndarray,
    ok: jnp.ndarray,
):
    """Per-agent RANSAC + match construction on the LK result (everything
    except tracking and detection). Returns (matches, tracked)."""
    f = params.budget
    dtype = img.dtype

    key = jax.random.PRNGKey(0)  # deterministic; hypotheses vary per frame
    key = jax.random.fold_in(key, state.next_id)
    inliers, _f = _ransac(params, state.pts, cur_pts, ok, key)
    tracked = ok & inliers

    # -------- matches (undistorted, normalized) ----------------------------
    prev_n = cam_mod.normalize(cam, cam_mod.undistort(cam, state.pts))
    cur_n = cam_mod.normalize(cam, cam_mod.undistort(cam, cur_pts))
    if params.compute_descriptors:
        from ..place_recognition import descriptors as desc_mod

        desc, desc_ok = desc_mod.compute(img, cur_pts, tracked)
    else:
        desc = jnp.zeros((f, 32), jnp.uint8)
        desc_ok = jnp.zeros((f,), bool)
    # tile of the current pixel observation (feeds the track manager's
    # SLAM-feature spreading, track_manager.cpp:325-395)
    h_img, w_img = img.shape
    tile_r = jnp.clip(
        (cur_pts[:, 1] * params.n_tiles_h / h_img).astype(jnp.int32),
        0, params.n_tiles_h - 1,
    )
    tile_c = jnp.clip(
        (cur_pts[:, 0] * params.n_tiles_w / w_img).astype(jnp.int32),
        0, params.n_tiles_w - 1,
    )
    tile = jnp.where(tracked, tile_r * params.n_tiles_w + tile_c, -1)
    matches = Matches(
        track_id=jnp.where(tracked, state.ids, -1),
        prev_pt=jnp.where(tracked[:, None], prev_n, 0.0).astype(dtype),
        cur_pt=jnp.where(tracked[:, None], cur_n, 0.0).astype(dtype),
        valid=tracked,
        desc=desc,
        desc_valid=desc_ok & tracked,
        tile=tile,
        level=jnp.where(tracked, state.levels, 0),
    )
    return matches, tracked


def _integrate(
    params: TrackerParams,
    state: TrackerState,
    img: jnp.ndarray,
    tracked,
    cur_pts,
    cand_xy,
    cand_score,
    cand_level,
    cand_valid,
):
    """Per-agent slot update: keep tracked features, fill free slots with
    the best detection candidates (score-sorted append, tracker.cpp:564-590)."""
    f = params.budget
    dtype = img.dtype
    pts1 = jnp.where(tracked[:, None], cur_pts, 0.0)
    ids1 = jnp.where(tracked, state.ids, -1)
    scores1 = jnp.where(tracked, state.scores, 0.0)
    levels1 = jnp.where(tracked, state.levels, 0)

    order = jnp.argsort(-jnp.where(cand_valid, cand_score, -jnp.inf), stable=True)
    cand_xy = cand_xy[order]
    cand_score = cand_score[order]
    cand_level = cand_level[order]
    cand_valid = cand_valid[order]

    free = ~tracked
    free_idx = jnp.argsort(~free, stable=True)  # free slots first
    n_free = jnp.sum(free)
    c = cand_xy.shape[0]
    rank = jnp.arange(c)
    can_place = cand_valid & (rank < n_free)
    tgt = jnp.where(can_place, free_idx[jnp.clip(rank, 0, f - 1)], f)

    new_ids = state.next_id + jnp.cumsum(can_place.astype(jnp.int32)) - 1

    def scat(base, rows):
        padded = jnp.concatenate([base, jnp.zeros_like(base[:1])], axis=0)
        return padded.at[tgt].set(rows)[:f]

    pts2 = scat(pts1, cand_xy.astype(dtype))
    ids2 = scat(ids1, new_ids)
    scores2 = scat(scores1, cand_score.astype(dtype))
    levels2 = scat(levels1, cand_level)
    next_id = state.next_id + jnp.sum(can_place)

    return TrackerState(
        pts=pts2,
        ids=ids2,
        scores=scores2,
        levels=levels2,
        next_id=next_id.astype(jnp.int32),
        prev_img=img,
        has_prev=jnp.asarray(True),
    )


def _n_candidates(params: TrackerParams, h: int, w: int) -> int:
    """Static candidate-slot count produced by :func:`_detect_new`."""
    # len(pyramid) = lk_max_level + 1 (image.build_pyramid)
    n_levels = min(params.pyramid_depth, params.lk_max_level + 1)
    return n_levels * params.n_tiles_h * params.n_tiles_w * params.max_feat_per_tile


def track_frame_batch(
    params: TrackerParams,
    cam: cam_mod.Camera,
    state: TrackerState,
    imgs: jnp.ndarray,  # (A, H, W)
) -> Tuple[TrackerState, Matches]:
    """One tracker frame for a BATCH of agents (leading axis A on every
    ``state`` leaf and on ``imgs``).

    Detection follows the reference's re-detect-on-demand semantics
    (``tracker.cpp:204-228``): the FAST + suppression branch only
    *executes* when at least one agent has dropped below ``n_feat_min``
    live tracks (a batch-level ``lax.cond``); per-agent gating of which
    candidates are actually appended is unchanged. In the steady state
    (most frames) the whole detection stage is skipped on device.
    """
    a, h, w = imgs.shape
    dtype = imgs.dtype
    depth = params.lk_max_level

    pyr_prev = jax.vmap(lambda im: build_pyramid(im, depth))(state.prev_img)
    pyr_cur = jax.vmap(lambda im: build_pyramid(im, depth))(imgs)

    cur_pts, ok = lk.track_batch(
        pyr_prev, pyr_cur, state.pts, (state.ids >= 0) & state.has_prev[:, None],
        half_win=params.win_half, n_iters=params.lk_iters,
        min_eig_thr=params.min_eig_thr,
    )
    matches, tracked = jax.vmap(
        lambda st, im, cp, o: _track_core(params, cam, st, im, cp, o)
    )(state, imgs, cur_pts, ok)

    pts1 = jnp.where(tracked[..., None], cur_pts, 0.0)
    n_live = jnp.sum(tracked, axis=1)
    need_detect = n_live < params.n_feat_min  # (A,)

    def do_detect(_):
        cand_xy, cand_score, cand_level, cand_valid = _detect_new_batch(
            params, pyr_cur, pts1, tracked
        )
        cand_valid = cand_valid & need_detect[:, None]
        return jax.vmap(
            lambda st, im, trk, cp, cxy, cs, cl, cv: _integrate(
                params, st, im, trk, cp, cxy, cs, cl, cv
            )
        )(state, imgs, tracked, cur_pts, cand_xy, cand_score, cand_level,
          cand_valid)

    def no_detect(_):
        # steady state: keep tracked features, no candidate append — and
        # no per-agent argsorts/scatters either (they cost time even with
        # zero candidates)
        return TrackerState(
            pts=pts1.astype(dtype),
            ids=jnp.where(tracked, state.ids, -1),
            scores=jnp.where(tracked, state.scores, 0.0),
            levels=jnp.where(tracked, state.levels, 0),
            next_id=state.next_id,
            prev_img=imgs,
            has_prev=jnp.ones((a,), bool),
        )

    new_state = jax.lax.cond(jnp.any(need_detect), do_detect, no_detect, None)
    return new_state, matches


def track_frame(
    params: TrackerParams,
    cam: cam_mod.Camera,
    state: TrackerState,
    img: jnp.ndarray,
) -> Tuple[TrackerState, Matches]:
    """One tracker frame for a single agent. Returns (new_state, matches
    in normalized undistorted coords)."""
    state_b = jax.tree.map(lambda x: jnp.asarray(x)[None], state)
    new_b, matches_b = track_frame_batch(params, cam, state_b, img[None])
    unbatch = lambda x: x[0]
    return jax.tree.map(unbatch, new_b), jax.tree.map(unbatch, matches_b)


def _ransac(params: TrackerParams, pts_prev, pts_cur, ok, key):
    from ..ops.ransac import fundamental_ransac

    return fundamental_ransac(
        pts_prev, pts_cur, ok, key, params.ransac_threshold_px,
        params.ransac_hypotheses,
    )


track_frame_jit = jax.jit(track_frame, static_argnums=(0, 1))
track_frame_batch_jit = jax.jit(track_frame_batch, static_argnums=(0, 1))
