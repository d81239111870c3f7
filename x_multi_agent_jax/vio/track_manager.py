"""Track classification & bookkeeping as fixed-shape tensor ops.

Behavioral spec: reference ``src/x/vio/track_manager.cpp``
(``manageTracks``, ``track_manager.cpp:115-436``). Dynamic track lists
become slot arrays + masks:

  * SLAM tracks live in N slots aligned 1:1 with the filter's feature
    states (``VisionState.f_arr``); removing a lost feature applies the
    *same* compaction permutation to tracks, feature states and covariance.
  * opportunistic tracks live in a K-slot pool; identity is a track id
    carried by the tracker/feeder (replacing the reference's
    feature-equality match association, ``track_manager.cpp:146``).
  * per-frame classes (MSCKF / short-MSCKF / new-SLAM std & MSCKF-SLAM)
    are emitted into fixed budgets via mask-compaction (stable argsort).

Observation storage is window-aligned: obs slot m corresponds to sliding
window pose slot m. On every frame live tracks shift left by one (the
window slides) and the new observation lands in slot M-1. Dead tracks keep
the pre-shift alignment, which is exactly what the short-MSCKF update needs
(it runs against the pre-slide pose list, reference ``updater.cpp:52-75``).

Per-tile feature *spreading/eviction* (``track_manager.cpp:325-395``) is
implemented as a fixed-shape scan (:func:`_spread_scan`) and enabled by
setting ``TrackDims.n_tiles_h/w > 0``; tiles ride on matches (-1 = no tile
info -> pure length-ranked promotion, the 0 x 0 behavior).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


class TrackDims(NamedTuple):
    n_slam: int = 15  # == StateDims.n_features
    n_poses: int = 15  # == StateDims.n_poses (M)
    n_opp: int = 60  # opportunistic pool slots
    n_matches: int = 200  # per-frame match budget
    n_msckf: int = 10  # MSCKF tracks per frame budget
    n_short: int = 10  # short-MSCKF tracks per frame budget
    n_new_slam: int = 15  # new SLAM features per frame budget (<= n_slam)
    # image tile grid for SLAM-feature spatial spreading
    # (track_manager.cpp:325-395); 0 x 0 disables the heuristic
    n_tiles_h: int = 0
    n_tiles_w: int = 0


@_pytree_dataclass
class TrackSlots:
    """Persistent track storage (one per agent)."""

    slam_obs: jnp.ndarray  # (N, M, 2)
    slam_mask: jnp.ndarray  # (N, M) bool
    slam_id: jnp.ndarray  # (N,) int32, -1 = inactive
    slam_length: jnp.ndarray  # (N,) int32 total obs count (chi2 dof)
    opp_obs: jnp.ndarray  # (K, M, 2)
    opp_mask: jnp.ndarray  # (K, M)
    opp_id: jnp.ndarray  # (K,)
    opp_length: jnp.ndarray  # (K,)
    slam_desc: jnp.ndarray  # (N, 32) uint8: last-obs descriptor (MULTI_UAV)
    slam_desc_valid: jnp.ndarray  # (N,)
    opp_desc: jnp.ndarray  # (K, 32) uint8
    opp_desc_valid: jnp.ndarray  # (K,)
    slam_tile: jnp.ndarray  # (N,) int32 tile of last obs (-1 unknown)
    opp_tile: jnp.ndarray  # (K,) int32

    @staticmethod
    def zero(dims: TrackDims, dtype=jnp.float32) -> "TrackSlots":
        n, m, k = dims.n_slam, dims.n_poses, dims.n_opp
        return TrackSlots(
            slam_obs=jnp.zeros((n, m, 2), dtype),
            slam_mask=jnp.zeros((n, m), bool),
            slam_id=jnp.full((n,), -1, jnp.int32),
            slam_length=jnp.zeros((n,), jnp.int32),
            opp_obs=jnp.zeros((k, m, 2), dtype),
            opp_mask=jnp.zeros((k, m), bool),
            opp_id=jnp.full((k,), -1, jnp.int32),
            opp_length=jnp.zeros((k,), jnp.int32),
            slam_desc=jnp.zeros((n, 32), jnp.uint8),
            slam_desc_valid=jnp.zeros((n,), bool),
            opp_desc=jnp.zeros((k, 32), jnp.uint8),
            opp_desc_valid=jnp.zeros((k,), bool),
            slam_tile=jnp.full((n,), -1, jnp.int32),
            opp_tile=jnp.full((k,), -1, jnp.int32),
        )


@_pytree_dataclass
class Matches:
    """Per-frame feature matches in normalized undistorted coordinates.

    ``track_id`` is stable across frames (tracker/feeder-assigned); a match
    whose id is not in any live track starts a new opportunistic track with
    (prev, cur) as its first two observations.
    """

    track_id: jnp.ndarray  # (J,) int32
    prev_pt: jnp.ndarray  # (J, 2)
    cur_pt: jnp.ndarray  # (J, 2)
    valid: jnp.ndarray  # (J,) bool
    desc: jnp.ndarray  # (J, 32) uint8 binary descriptor of the current obs
    desc_valid: jnp.ndarray  # (J,) bool
    tile: jnp.ndarray  # (J,) int32 image tile of the current obs (-1 n/a)
    level: jnp.ndarray  # (J,) int32 pyramid level at detection (0 = base;
    # reference Feature pyramid-level field, tracker.cpp:432-449)

    @staticmethod
    def zero(dims: TrackDims, dtype=jnp.float32) -> "Matches":
        j = dims.n_matches
        return Matches(
            track_id=jnp.full((j,), -1, jnp.int32),
            prev_pt=jnp.zeros((j, 2), dtype),
            cur_pt=jnp.zeros((j, 2), dtype),
            valid=jnp.zeros((j,), bool),
            desc=jnp.zeros((j, 32), jnp.uint8),
            desc_valid=jnp.zeros((j,), bool),
            tile=jnp.full((j,), -1, jnp.int32),
            level=jnp.zeros((j,), jnp.int32),
        )

    @staticmethod
    def of(track_id, prev_pt, cur_pt, valid, desc=None, desc_valid=None,
           tile=None, level=None) -> "Matches":
        if desc is None:
            desc = jnp.zeros(track_id.shape + (32,), jnp.uint8)
            desc_valid = jnp.zeros(track_id.shape, bool)
        if tile is None:
            tile = jnp.full(track_id.shape, -1, jnp.int32)
        if level is None:
            level = jnp.zeros(track_id.shape, jnp.int32)
        return Matches(track_id, prev_pt, cur_pt, valid, desc, desc_valid,
                       tile, level)


@_pytree_dataclass
class FrameTracks:
    """Per-frame classified measurement sets (fixed budgets)."""

    # SLAM: aligned with feature slots (post-shift, current obs at M-1)
    slam_has_obs: jnp.ndarray  # (N,)
    lost_slam: jnp.ndarray  # (N,) active slots that died this frame
    # MSCKF: full-window opportunistic tracks, post-shift alignment
    msckf_obs: jnp.ndarray  # (Km, M, 2)
    msckf_mask: jnp.ndarray  # (Km, M)
    msckf_valid: jnp.ndarray  # (Km,)
    msckf_id: jnp.ndarray  # (Km,) track ids (cross-agent match store join)
    # short MSCKF: dead tracks, PRE-shift alignment (old window)
    short_obs: jnp.ndarray  # (Ks, M, 2)
    short_mask: jnp.ndarray  # (Ks, M)
    short_valid: jnp.ndarray  # (Ks,)
    short_id: jnp.ndarray  # (Ks,) track ids (cross-agent match store join)
    # new SLAM features (MSCKF-SLAM group first, then std — matches the
    # state-insertion order, vio_updater.cpp postUpdate)
    new_obs: jnp.ndarray  # (Kn, M, 2)
    new_mask: jnp.ndarray  # (Kn, M)
    new_valid: jnp.ndarray  # (Kn,)
    new_is_msckf: jnp.ndarray  # (Kn,) baseline-OK -> MSCKF-SLAM init
    new_id: jnp.ndarray  # (Kn,)
    new_length: jnp.ndarray  # (Kn,)
    new_desc: jnp.ndarray  # (Kn, 32)
    new_desc_valid: jnp.ndarray  # (Kn,)
    new_tile: jnp.ndarray  # (Kn,) int32


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def stable_partition(keep: jnp.ndarray) -> jnp.ndarray:
    """Stable permutation putting kept slots first.

    Two cumsums + a unique-position scatter instead of argsort: a sort
    costs ~n log^2 n small vector ops per call, and manage_tracks runs
    several per frame."""
    n = keep.shape[0]
    n_keep = jnp.sum(keep)
    pos = jnp.where(keep, jnp.cumsum(keep) - 1, n_keep + jnp.cumsum(~keep) - 1)
    return jnp.zeros((n,), jnp.int32).at[pos].set(jnp.arange(n, dtype=jnp.int32))


def compaction_perm(keep: jnp.ndarray) -> jnp.ndarray:
    """Stable permutation putting kept slots first (used for both track
    slots and feature states/covariance so they stay aligned)."""
    return stable_partition(keep)


def _select_budget(mask: jnp.ndarray, order_key: jnp.ndarray, budget: int):
    """Pick up to ``budget`` slots where mask, highest order_key first
    (ties broken by lower slot index, like the stable argsort it
    replaces — the fractional index bias makes top_k's tie-breaking
    explicit).

    Returns (indices (budget,), valid (budget,)).
    """
    n = mask.shape[0]
    key = jnp.where(mask, order_key.astype(jnp.float32), -jnp.inf)
    # strictly decreasing index epsilon => deterministic lower-index-first
    # tie-break regardless of the top_k implementation
    key = key - jnp.arange(n, dtype=jnp.float32) * (1.0 / (2.0 * n))
    _, idx = jax.lax.top_k(key, budget)
    valid = mask[idx]
    return idx.astype(jnp.int32), valid


def check_baseline(
    obs: jnp.ndarray,  # (M, 2)
    mask: jnp.ndarray,  # (M,)
    q_list: jnp.ndarray,  # (M, 4) camera attitudes, window-aligned
    last_idx,  # traced: index of the reference (last) pose/obs
    min_baseline_x: float,
    min_baseline_y: float,
):
    """Rotation-compensated normalized-coordinate spread test (reference
    ``TrackManager::checkBaseline``, ``track_manager.cpp:576-636``)."""
    dtype = obs.dtype
    q_n = q_list[last_idx]

    # Cn_q_Ci = Ci_q_G^-1 * Cn_q_G ; ray_Cn = R(Cn_q_Ci)^T @ ray_Ci
    q_rel = lie.quat_multiply(lie.quat_conjugate(q_list), q_n[None])  # (M,4)
    r_rel = lie.quat_to_rot(q_rel)  # (M,3,3)
    rays = jnp.concatenate([obs, jnp.ones(obs.shape[:-1] + (1,), dtype)], -1)
    rot = jnp.einsum("mji,mj->mi", r_rel, rays)  # R^T @ ray
    z = rot[:, 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1.0)
    xy = rot[:, :2] / safe_z[:, None]

    big = jnp.asarray(jnp.inf, dtype)
    x = jnp.where(mask, xy[:, 0], big)
    y = jnp.where(mask, xy[:, 1], big)
    dx = jnp.max(jnp.where(mask, xy[:, 0], -big)) - jnp.min(x)
    dy = jnp.max(jnp.where(mask, xy[:, 1], -big)) - jnp.min(y)
    return (dx > min_baseline_x) | (dy > min_baseline_y)


def _spread_scan(
    n_bins: int,
    slam_tile: jnp.ndarray,  # (N,) existing SLAM tracks' tiles (-1 inactive)
    slam_alive: jnp.ndarray,  # (N,) active and not already lost
    cand_tile: jnp.ndarray,  # (Kc,) candidate tiles, length-desc order
    cand_valid: jnp.ndarray,  # (Kc,)
    n_slam_free,
):
    """Per-tile SLAM-feature spreading with eviction (reference
    ``track_manager.cpp:310-395``), as a fixed-shape sequential scan over
    the (length-sorted) promotion candidates.

    Per candidate: promote into a free slot if any; else, if the fullest
    bin holds >= 2 more features than the candidate's bin, evict the
    *youngest* feature of that bin (preferring a candidate accepted this
    frame — reference ``bin_track_idx[..].back() >= slam_trks_.size()`` —
    else the newest existing SLAM track, which is excised as a lost
    feature after the update) and take its slot; else reject.

    Returns (accept (Kc,), evict (N,)).
    """
    n = slam_tile.shape[0]
    kc = cand_tile.shape[0]
    bins = jnp.arange(n_bins, dtype=jnp.int32)
    counts0 = jnp.sum(
        (slam_tile[None, :] == bins[:, None]) & slam_alive[None, :], axis=1
    ).astype(jnp.int32)

    def body(carry, t):
        counts, free, accept, evict = carry
        bt = jnp.clip(cand_tile[t], 0, n_bins - 1)
        valid = cand_valid[t] & (cand_tile[t] >= 0)
        maxbin = jnp.argmax(counts).astype(jnp.int32)
        maxcount = counts[maxbin]

        take_free = valid & (free > 0)
        can_evict = valid & (free <= 0) & (maxcount > counts[bt] + 1)

        # eviction target: youngest accepted candidate in maxbin, else
        # youngest (highest-slot) existing SLAM track in maxbin
        acc_in_max = accept & (cand_tile == maxbin)
        has_new = acc_in_max.any()
        # youngest accepted candidate = highest candidate index (candidates
        # are appended in scan order)
        new_j = jnp.argmax(
            jnp.where(acc_in_max, jnp.arange(kc), -1)
        ).astype(jnp.int32)
        slam_in_max = slam_alive & ~evict & (slam_tile == maxbin)
        old_j = jnp.argmax(
            jnp.where(slam_in_max, jnp.arange(n), -1)
        ).astype(jnp.int32)
        has_old = slam_in_max.any()
        do_evict = can_evict & (has_new | has_old)

        accept = accept.at[new_j].set(
            jnp.where(do_evict & has_new, False, accept[new_j])
        )
        evict = evict.at[old_j].set(
            jnp.where(do_evict & ~has_new & has_old, True, evict[old_j])
        )
        counts = counts.at[maxbin].add(jnp.where(do_evict, -1, 0))

        took = take_free | do_evict
        accept = accept.at[t].set(took)
        counts = counts.at[bt].add(jnp.where(took, 1, 0))
        free = free - jnp.where(take_free, 1, 0)
        return (counts, free, accept, evict), None

    accept0 = jnp.zeros((kc,), bool)
    evict0 = jnp.zeros((n,), bool)
    (counts, free, accept, evict), _ = jax.lax.scan(
        body,
        (counts0, jnp.asarray(n_slam_free, jnp.int32), accept0, evict0),
        jnp.arange(kc),
    )
    return accept, evict


# ---------------------------------------------------------------------------
# main per-frame classification
# ---------------------------------------------------------------------------


def manage_tracks(
    dims: TrackDims,
    slots: TrackSlots,
    matches: Matches,
    q_list_old: jnp.ndarray,  # (M, 4) pre-slide cam attitudes... see note
    q_cur: jnp.ndarray,  # (4,) current camera attitude (world<-cam)
    min_track_length: int,
    min_baseline_x: float,
    min_baseline_y: float,
    prev_pose_valid=True,
):
    """One frame of track bookkeeping.

    ``q_list_old`` is the pre-slide window attitude list; the baseline
    checks use [old slots 1..M-1] + current attitude, exactly the cropped
    list the reference builds in preProcess (``vio_updater.cpp:145-152``).

    Returns (new_slots, FrameTracks, slam_current_obs (N,2)).
    """
    n, m, k = dims.n_slam, dims.n_poses, dims.n_opp
    dtype = slots.slam_obs.dtype

    mid = jnp.where(matches.valid, matches.track_id, -2)

    # post-slide attitude list for baseline checks (current pose at M-1)
    q_list_new = jnp.concatenate([q_list_old[1:], q_cur[None]], axis=0)

    # ---------------- SLAM tracks ----------------
    slam_active = slots.slam_id >= 0
    slam_hit = slots.slam_id[:, None] == mid[None, :]  # (N, J)
    slam_found = slam_hit.any(axis=1) & slam_active
    slam_match_idx = jnp.argmax(slam_hit, axis=1)
    slam_new_pt = matches.cur_pt[slam_match_idx]

    shift = lambda a: jnp.concatenate([a[:, 1:], jnp.zeros_like(a[:, :1])], axis=1)
    slam_obs_shift = shift(slots.slam_obs)
    slam_mask_shift = shift(slots.slam_mask)
    slam_obs_new = slam_obs_shift.at[:, m - 1].set(slam_new_pt)
    slam_mask_new = slam_mask_shift.at[:, m - 1].set(True)

    lost_slam = slam_active & ~slam_found
    slam_obs2 = jnp.where(slam_found[:, None, None], slam_obs_new, slots.slam_obs)
    slam_mask2 = jnp.where(slam_found[:, None], slam_mask_new, slots.slam_mask)
    slam_len2 = slots.slam_length + slam_found.astype(jnp.int32)
    upd_desc = slam_found & matches.desc_valid[slam_match_idx]
    slam_desc2 = jnp.where(
        upd_desc[:, None], matches.desc[slam_match_idx], slots.slam_desc
    )
    slam_desc_valid2 = jnp.where(upd_desc, True, slots.slam_desc_valid & slam_found)
    upd_tile = slam_found & (matches.tile[slam_match_idx] >= 0)
    slam_tile2 = jnp.where(upd_tile, matches.tile[slam_match_idx], slots.slam_tile)

    consumed_by_slam = (slam_hit & slam_active[:, None]).any(axis=0)  # (J,)

    # ---------------- opportunistic tracks ----------------
    opp_active = slots.opp_id >= 0
    opp_hit = (slots.opp_id[:, None] == mid[None, :]) & ~consumed_by_slam[None, :]
    opp_found = opp_hit.any(axis=1) & opp_active
    opp_match_idx = jnp.argmax(opp_hit, axis=1)
    opp_new_pt = matches.cur_pt[opp_match_idx]

    opp_dead = opp_active & ~opp_found  # pre-shift alignment preserved below

    # short-MSCKF: dead tracks with >= 2 obs and baseline over the *old*
    # cropped list (reference cam_rots_short = old slots 1..M-1). Their obs
    # alignment is unchanged (last obs at old slot M-1).
    short_baseline = jax.vmap(
        lambda o, msk: check_baseline(
            o, msk, q_list_old, m - 1, min_baseline_x, min_baseline_y
        )
    )(slots.opp_obs, slots.opp_mask)
    short_cand = opp_dead & (slots.opp_length >= 2) & short_baseline
    short_idx, short_valid = _select_budget(
        short_cand, slots.opp_length.astype(dtype), dims.n_short
    )
    short_obs = slots.opp_obs[short_idx]
    short_mask = slots.opp_mask[short_idx] & short_valid[:, None]
    short_id = jnp.where(short_valid, slots.opp_id[short_idx], -1)

    # live opp tracks: shift + append current obs
    opp_obs_shift = shift(slots.opp_obs)
    opp_mask_shift = shift(slots.opp_mask)
    opp_obs2 = jnp.where(
        opp_found[:, None, None],
        opp_obs_shift.at[:, m - 1].set(opp_new_pt),
        jnp.zeros_like(slots.opp_obs),
    )
    opp_mask2 = jnp.where(
        opp_found[:, None], opp_mask_shift.at[:, m - 1].set(True), False
    )
    opp_id2 = jnp.where(opp_found, slots.opp_id, -1)
    opp_len2 = jnp.where(opp_found, slots.opp_length + 1, 0)
    upd_odesc = opp_found & matches.desc_valid[opp_match_idx]
    opp_desc2 = jnp.where(
        upd_odesc[:, None], matches.desc[opp_match_idx], slots.opp_desc
    )
    opp_desc_valid2 = jnp.where(upd_odesc, True, slots.opp_desc_valid & opp_found)
    upd_otile = opp_found & (matches.tile[opp_match_idx] >= 0)
    opp_tile2 = jnp.where(upd_otile, matches.tile[opp_match_idx], slots.opp_tile)

    # new opportunistic tracks from unconsumed matches
    match_known = (
        consumed_by_slam
        | ((slots.opp_id[:, None] == mid[None, :]) & opp_active[:, None]).any(0)
    )
    is_new_match = matches.valid & ~match_known & (matches.track_id >= 0)
    free_slot = ~opp_found  # dead or inactive slots are reusable
    # rank new matches and free slots, pair them up
    new_rank = jnp.cumsum(is_new_match) - 1  # (J,)
    free_idx = stable_partition(free_slot)  # free slots first
    n_free = jnp.sum(free_slot)
    can_place = is_new_match & (new_rank < n_free)
    target = free_idx[jnp.clip(new_rank, 0, k - 1)]  # (J,)

    def place(opp_obs, opp_mask, opp_id, opp_len, opp_desc, opp_dv, opp_tile):
        # vectorized scatter: each placeable match gets a distinct free slot
        # (targets are free_idx[rank] with distinct ranks); non-placeable
        # matches are dumped into a sacrificial extra row.
        jm = matches.valid.shape[0]
        tgt = jnp.where(can_place, target, k)  # k = dump row

        new_obs = jnp.zeros((jm, m, 2), dtype)
        new_obs = new_obs.at[:, m - 2].set(matches.prev_pt)
        new_obs = new_obs.at[:, m - 1].set(matches.cur_pt)
        new_msk = jnp.zeros((jm, m), bool)
        # the previous observation belongs to the pose at slot M-2 of the
        # post-slide window; drop it if that pose isn't valid yet
        new_msk = new_msk.at[:, m - 2].set(jnp.asarray(prev_pose_valid))
        new_msk = new_msk.at[:, m - 1].set(True)

        def scat(base, rows):
            padded = jnp.concatenate([base, jnp.zeros_like(base[:1])], axis=0)
            return padded.at[tgt].set(rows)[:k]

        opp_obs = scat(opp_obs, new_obs)
        opp_mask = scat(opp_mask, new_msk)
        opp_id = scat(opp_id, matches.track_id)
        opp_len = scat(opp_len, jnp.full((jm,), 2, opp_len.dtype))
        opp_desc = scat(opp_desc, matches.desc)
        opp_dv = scat(opp_dv, matches.desc_valid)
        opp_tile = scat(opp_tile, matches.tile)
        return opp_obs, opp_mask, opp_id, opp_len, opp_desc, opp_dv, opp_tile

    (opp_obs2, opp_mask2, opp_id2, opp_len2, opp_desc2, opp_desc_valid2,
     opp_tile2) = place(
        opp_obs2, opp_mask2, opp_id2, opp_len2, opp_desc2, opp_desc_valid2,
        opp_tile2,
    )
    opp_active2 = opp_id2 >= 0

    # ---------------- promotions ----------------
    # baseline over the new window (current pose at M-1)
    live_baseline = jax.vmap(
        lambda o, msk: check_baseline(
            o, msk, q_list_new, m - 1, min_baseline_x, min_baseline_y
        )
    )(opp_obs2, opp_mask2)

    n_slam_free = n - jnp.sum(slam_active & ~lost_slam)  # slots after removals
    long_enough = opp_active2 & (opp_len2 > min_track_length - 1)
    # promote longest first into available SLAM budget
    promo_rank_key = opp_len2.astype(dtype)
    promo_idx, promo_valid = _select_budget(long_enough, promo_rank_key, dims.n_new_slam)
    n_bins = dims.n_tiles_h * dims.n_tiles_w
    if n_bins > 0:
        # per-tile spreading with eviction (track_manager.cpp:310-395)
        accept, evict = _spread_scan(
            n_bins,
            slam_tile2,
            slam_active & ~lost_slam,
            opp_tile2[promo_idx],
            promo_valid,
            n_slam_free,
        )
        promo_valid = accept
        lost_slam = lost_slam | evict
    else:
        promo_valid = promo_valid & (jnp.arange(dims.n_new_slam) < n_slam_free)

    new_obs = opp_obs2[promo_idx]
    new_mask = opp_mask2[promo_idx] & promo_valid[:, None]
    new_id = jnp.where(promo_valid, opp_id2[promo_idx], -1)
    new_length = jnp.where(promo_valid, opp_len2[promo_idx], 0)
    new_is_msckf = live_baseline[promo_idx] & promo_valid
    # order: MSCKF-SLAM group first, then std, invalid last (state-insertion order)
    order = jnp.argsort(
        jnp.where(promo_valid, (~new_is_msckf).astype(jnp.int32), 2), stable=True
    )
    new_desc = opp_desc2[promo_idx]
    new_desc_valid = opp_desc_valid2[promo_idx] & promo_valid
    new_tile = jnp.where(promo_valid, opp_tile2[promo_idx], -1)
    new_obs, new_mask = new_obs[order], new_mask[order]
    new_id, new_length = new_id[order], new_length[order]
    new_is_msckf = new_is_msckf[order]
    new_valid = promo_valid[order]
    new_desc, new_desc_valid = new_desc[order], new_desc_valid[order]
    new_tile = new_tile[order]

    promoted = jnp.zeros((k,), bool).at[promo_idx].set(promo_valid)

    # MSCKF: remaining live tracks spanning the full window + baseline OK
    # (reference: length > M-1 and not promotable)
    msckf_cand = opp_active2 & ~promoted & (opp_len2 > m - 1) & live_baseline
    msckf_idx, msckf_valid = _select_budget(
        msckf_cand, opp_len2.astype(dtype), dims.n_msckf
    )
    msckf_obs = opp_obs2[msckf_idx]
    msckf_mask = opp_mask2[msckf_idx] & msckf_valid[:, None]
    msckf_id = jnp.where(msckf_valid, opp_id2[msckf_idx], -1)

    consumed = promoted | (jnp.zeros((k,), bool).at[msckf_idx].set(msckf_valid))
    opp_id3 = jnp.where(consumed, -1, opp_id2)
    opp_mask3 = jnp.where(consumed[:, None], False, opp_mask2)
    opp_len3 = jnp.where(consumed, 0, opp_len2)
    opp_dv3 = jnp.where(consumed, False, opp_desc_valid2)

    new_slots = TrackSlots(
        slam_obs=slam_obs2,
        slam_mask=slam_mask2,
        slam_id=slots.slam_id,  # lost slots removed by apply_compaction later
        slam_length=slam_len2,
        opp_obs=opp_obs2,
        opp_mask=opp_mask3,
        opp_id=opp_id3,
        opp_length=opp_len3,
        slam_desc=slam_desc2,
        slam_desc_valid=slam_desc_valid2,
        opp_desc=opp_desc2,
        opp_desc_valid=opp_dv3,
        slam_tile=slam_tile2,
        opp_tile=opp_tile2,
    )
    frame = FrameTracks(
        slam_has_obs=slam_found,
        lost_slam=lost_slam,
        msckf_obs=msckf_obs,
        msckf_mask=msckf_mask,
        msckf_valid=msckf_valid,
        msckf_id=msckf_id,
        short_obs=short_obs,
        short_mask=short_mask,
        short_valid=short_valid,
        short_id=short_id,
        new_obs=new_obs,
        new_mask=new_mask,
        new_valid=new_valid,
        new_is_msckf=new_is_msckf,
        new_id=new_id,
        new_length=new_length,
        new_desc=new_desc,
        new_desc_valid=new_desc_valid,
        new_tile=new_tile,
    )
    return new_slots, frame, slam_new_pt


def apply_slam_compaction(slots: TrackSlots, perm: jnp.ndarray, n_keep) -> TrackSlots:
    """Apply the lost-feature compaction permutation to SLAM track slots
    (mirrors the feature-state/covariance excision in the state manager)."""
    n = perm.shape[0]
    keep = jnp.arange(n) < n_keep
    return dataclasses.replace(
        slots,
        slam_obs=jnp.where(keep[:, None, None], slots.slam_obs[perm], 0.0),
        slam_mask=jnp.where(keep[:, None], slots.slam_mask[perm], False),
        slam_id=jnp.where(keep, slots.slam_id[perm], -1),
        slam_length=jnp.where(keep, slots.slam_length[perm], 0),
        slam_desc=jnp.where(keep[:, None], slots.slam_desc[perm], 0),
        slam_desc_valid=jnp.where(keep, slots.slam_desc_valid[perm], False),
        slam_tile=jnp.where(keep, slots.slam_tile[perm], -1),
    )


def insert_new_slam_tracks(
    slots: TrackSlots,
    frame: FrameTracks,
    accepted: jnp.ndarray,  # (Kn,) new tracks actually initialized as features
    n_features_before,  # traced: feature count before insertion
) -> TrackSlots:
    """Write accepted new-SLAM tracks into SLAM slots n_before, n_before+1…
    in order (must match the feature-state insertion order)."""
    n = slots.slam_id.shape[0]
    rank = jnp.cumsum(accepted) - 1
    tgt = jnp.where(accepted, n_features_before + rank, n)  # n = dump row

    def scat(base, rows):
        padded = jnp.concatenate([base, jnp.zeros_like(base[:1])], axis=0)
        return padded.at[tgt].set(rows)[:n]

    return dataclasses.replace(
        slots,
        slam_obs=scat(slots.slam_obs, frame.new_obs),
        slam_mask=scat(slots.slam_mask, frame.new_mask),
        slam_id=scat(slots.slam_id, frame.new_id),
        slam_length=scat(slots.slam_length, frame.new_length),
        slam_desc=scat(slots.slam_desc, frame.new_desc),
        slam_desc_valid=scat(slots.slam_desc_valid, frame.new_desc_valid),
        slam_tile=scat(slots.slam_tile, frame.new_tile),
    )
