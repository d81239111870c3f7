"""Persistent cross-agent match containers + upgrade bookkeeping.

Behavioral spec: reference ``PlaceRecognition`` persistent match state —
``msckf_matches_`` / ``slam_matches_`` / ``opp_matches_`` merged on every
received payload (``place_recognition.cpp:525-577``) and re-classified on
every visual update by ``updateOppMatches`` (``place_recognition.cpp:
584-675``):

  * an OPP match whose own track is selected as MSCKF this frame and whose
    peer side was MSCKF-type upgrades to an MSCKF-MSCKF match, consumed by
    joint triangulation + N-way CI inside the visual update
    (``msckf_update.cpp:90-279``);
  * an OPP match whose own track was promoted to SLAM and whose peer side
    was SLAM upgrades to a SLAM-SLAM match (``place_recognition.cpp:
    617-640``), consumed by the pairwise-CI landmark update
    (``multi_slam_update.cpp``);
  * matched own tracks that DIE are fused as short-MSCKF against the
    pre-slide pose list (``track_manager.cpp:238-260`` — the only *active*
    ``opp_ids_`` promotion path; the live-track variant is compiled out
    with ``if (false && ...)`` at ``track_manager.cpp:286``);
  * matches whose own track is gone from every container are discarded
    (``place_recognition.cpp:646-667``).

Design: fixed shapes throughout. Peer payload snapshots live in a ring
of S slots (the reference holds shared_ptrs into received Keyframes);
match slots are a Q-row table joined against current track ids by masked
equality. All updates are pure functions of (store, slots, frame).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ekf.state import StateDims
from .payload import AgentPayload

PEER_COLLAB = 1  # peer side is a collaborative (MSCKF/OPP) track
PEER_SLAM = 2  # peer side is a SLAM feature


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


class StoreDims(NamedTuple):
    n_payloads: int = 4  # peer snapshot ring slots (S)
    n_matches: int = 16  # persistent match slots (Q)
    max_peers: int = 2  # joint-MSCKF peer budget per own track (P)


@_pytree_dataclass
class MatchStore:
    """Fixed-shape persistent match state (one per agent)."""

    # peer payload snapshot ring (S slots; stacked AgentPayload)
    pay: AgentPayload
    pay_uav: jnp.ndarray  # (S,) int32 sender id
    pay_valid: jnp.ndarray  # (S,) bool
    pay_head: jnp.ndarray  # int32 next write slot
    # match table (Q rows)
    own_id: jnp.ndarray  # (Q,) int32 own track id, -1 = free
    peer_type: jnp.ndarray  # (Q,) int32 PEER_COLLAB | PEER_SLAM
    pay_slot: jnp.ndarray  # (Q,) int32 snapshot holding the peer data
    peer_idx: jnp.ndarray  # (Q,) int32 index into pay.trk_* or pay.f_arr
    uav_id: jnp.ndarray  # (Q,) int32 peer agent id

    @staticmethod
    def zero(dims: StateDims, sdims: StoreDims, n_collab_tracks: int = 8,
             dtype=jnp.float32) -> "MatchStore":
        from .payload import make_payload
        from ..ekf.state import VisionState

        s, q = sdims.n_payloads, sdims.n_matches
        one = make_payload(
            dims, 0.0, VisionState.zero(dims, dtype),
            jnp.zeros((dims.d, dims.d), dtype),
            n_collab_tracks=n_collab_tracks,
        )
        pay = jax.tree.map(lambda x: jnp.broadcast_to(x, (s,) + x.shape), one)
        return MatchStore(
            pay=pay,
            pay_uav=jnp.full((s,), -1, jnp.int32),
            pay_valid=jnp.zeros((s,), bool),
            pay_head=jnp.asarray(0, jnp.int32),
            own_id=jnp.full((q,), -1, jnp.int32),
            peer_type=jnp.zeros((q,), jnp.int32),
            pay_slot=jnp.zeros((q,), jnp.int32),
            peer_idx=jnp.zeros((q,), jnp.int32),
            uav_id=jnp.full((q,), -1, jnp.int32),
        )


def record(
    store: MatchStore,
    slots,  # tm.TrackSlots
    payload: AgentPayload,
    uav_id,
    desc_ratio_thr: float,
    desc_abs_thr: float,
    store_when=True,
    ransac_thr: float = 0.0,
) -> MatchStore:
    """Descriptor-match own OPP tracks against a received payload and merge
    the matches (reference ``findCorrespondences`` OPP classification +
    container merge, ``place_recognition.cpp:311-383,525-577``).

    Own-SLAM x peer-SLAM matches are *not* stored: they are consumed
    immediately by the caller (``fuse_with_peer_desc``), matching the
    reference, which fuses SLAM matches in the same
    ``processOtherMeasurements`` call. (Own-SLAM x peer-MSCKF and
    own-MSCKF x peer-SLAM upgrades are unimplemented in the reference —
    ``place_recognition.cpp:607,621`` — and skipped here too.)
    """
    from ..place_recognition.descriptors import knn2_match

    q = store.own_id.shape[0]

    slot = store.pay_head
    own_id0 = _stale_own_ids(store, slot, store_when)

    # own OPP tracks vs the peer's collaborative track set
    c_idx, c_ok = knn2_match(
        slots.opp_desc, slots.opp_desc_valid & (slots.opp_id >= 0),
        payload.trk_desc, payload.trk_desc_valid,
        desc_ratio_thr, desc_abs_thr,
    )
    # own OPP tracks vs the peer's SLAM features
    s_idx, s_ok = knn2_match(
        slots.opp_desc, slots.opp_desc_valid & (slots.opp_id >= 0),
        payload.slam_desc, payload.slam_desc_valid,
        desc_ratio_thr, desc_abs_thr,
    )
    # prefer the collaborative-track match when both hit (the reference
    # classifies by best distance; collab tracks carry the full window and
    # give the stronger joint update)
    s_ok = s_ok & ~c_ok
    cand_id = slots.opp_id
    cand_type = jnp.where(c_ok, PEER_COLLAB, PEER_SLAM)
    cand_idx = jnp.where(c_ok, c_idx, s_idx)
    cand_ok = (c_ok | s_ok) & store_when

    if ransac_thr > 0:
        # geometric verification over the matched current observations
        # (reference findEssentialMat gate, place_recognition.cpp:269-283)
        from ..ops.ransac import fundamental_ransac

        m = slots.opp_obs.shape[1]
        own_pts = slots.opp_obs[:, m - 1]
        # peer side: last valid obs of the matched collab track, or the
        # SLAM feature's last observation
        last_slot = jnp.argmax(
            jnp.where(payload.trk_mask, jnp.arange(m)[None, :], -1), axis=1
        )
        trk_last = payload.trk_obs[jnp.arange(payload.trk_obs.shape[0]), last_slot]
        peer_pts = jnp.where(
            c_ok[:, None], trk_last[c_idx], payload.slam_obs[s_idx]
        )
        # fold the payload time and sender id into the key so every call
        # draws a fresh hypothesis set (vision/tracker.py pattern)
        key = jax.random.fold_in(
            jax.random.fold_in(
                jax.random.PRNGKey(11),
                jnp.asarray(payload.time, jnp.float32).view(jnp.int32),
            ),
            jnp.asarray(uav_id, jnp.int32),
        )
        inl, _ = fundamental_ransac(
            own_pts, peer_pts, cand_ok, key, ransac_thr
        )
        cand_ok = cand_ok & inl

    return _merge_candidates(
        store, payload, uav_id, own_id0, cand_id, cand_type, cand_idx,
        cand_ok, store_when,
    )


def _stale_own_ids(store: MatchStore, slot, store_when):
    """Invalidate matches that reference the about-to-be-overwritten
    payload ring slot; returns the cleaned own_id column."""
    stale = (store.pay_slot == slot) & (store.own_id >= 0) & store_when
    return jnp.where(stale, -1, store.own_id)


def record_gt(
    store: MatchStore,
    slots,  # tm.TrackSlots
    payload: AgentPayload,
    uav_id,
    store_when=True,
) -> MatchStore:
    """GT_DEBUG classification of a received payload by track-id equality
    (reference ``place_recognition.cpp:387-517``: cross-agent matches come
    from ground-truth landmark proximity; with sim-assigned GLOBAL track
    ids, id equality is that association made exact). Emits the same
    three-type match records as the descriptor path:

      * own OPP x peer collaborative track -> PEER_COLLAB (the reference's
        OPP x MSCKF / OPP x OPP MsckfMatch loops) — upgraded by
        ``update_and_harvest`` to joint-MSCKF / short-CI work;
      * own OPP x peer SLAM -> PEER_SLAM (the OppMatch(MatchType::SLAM)
        loop) — upgraded to SLAM-SLAM on own-track promotion;
      * own SLAM x peer SLAM is NOT stored (consumed immediately by the
        caller's landmark fusion, like the reference and the descriptor
        path).
    """
    slot = store.pay_head
    own_id0 = _stale_own_ids(store, slot, store_when)

    opp_ok = slots.opp_id >= 0
    # id-equality joins against the peer's track/SLAM id columns
    c_hit = opp_ok[:, None] & (
        slots.opp_id[:, None] == payload.trk_id[None, :]
    ) & (payload.trk_id[None, :] >= 0)
    s_hit = opp_ok[:, None] & (
        slots.opp_id[:, None] == payload.slam_id[None, :]
    ) & (payload.slam_id[None, :] >= 0)
    c_ok = c_hit.any(axis=1)
    s_ok = s_hit.any(axis=1) & ~c_ok
    c_idx = jnp.argmax(c_hit, axis=1).astype(jnp.int32)
    s_idx = jnp.argmax(s_hit, axis=1).astype(jnp.int32)

    cand_id = slots.opp_id
    cand_type = jnp.where(c_ok, PEER_COLLAB, PEER_SLAM)
    cand_idx = jnp.where(c_ok, c_idx, s_idx)
    cand_ok = (c_ok | s_ok) & store_when
    return _merge_candidates(
        store, payload, uav_id, own_id0, cand_id, cand_type, cand_idx,
        cand_ok, store_when,
    )


def _merge_candidates(
    store: MatchStore, payload: AgentPayload, uav_id, own_id0,
    cand_id, cand_type, cand_idx, cand_ok, store_when,
) -> MatchStore:
    """Shared tail of record()/record_gt(): payload ring write, dedup
    against stored (own_id, uav) pairs, rank-compacted scatter into free
    match rows (place_recognition.cpp:525-577 container merge)."""
    q = store.own_id.shape[0]
    slot = store.pay_head
    pay = jax.tree.map(
        lambda buf, x: buf.at[slot].set(jnp.where(store_when, x, buf[slot])),
        store.pay, payload,
    )
    pay_uav = store.pay_uav.at[slot].set(
        jnp.where(store_when, jnp.asarray(uav_id, jnp.int32), store.pay_uav[slot])
    )
    pay_valid = store.pay_valid.at[slot].set(
        jnp.where(store_when, True, store.pay_valid[slot])
    )

    # dedup: drop candidates already stored for the same (own_id, uav)
    dup = (
        (own_id0[None, :] == cand_id[:, None])
        & (store.uav_id[None, :] == jnp.asarray(uav_id, jnp.int32))
        & (own_id0[None, :] >= 0)
    ).any(axis=1)
    cand_ok = cand_ok & ~dup

    # scatter candidates into free match rows (rank-compaction, same
    # pattern as the track-slot placement in track_manager.place)
    free = own_id0 < 0
    rank = jnp.cumsum(cand_ok) - 1
    free_idx = jnp.argsort(~free, stable=True)
    n_free = jnp.sum(free)
    can_place = cand_ok & (rank < n_free)
    kq = free_idx.shape[0]
    tgt = jnp.where(can_place, free_idx[jnp.clip(rank, 0, kq - 1)], q)

    def scat(base, rows):
        padded = jnp.concatenate([base, jnp.zeros_like(base[:1])], axis=0)
        return padded.at[tgt].set(rows)[:q]

    return dataclasses.replace(
        store,
        pay=pay,
        pay_uav=pay_uav,
        pay_valid=pay_valid,
        pay_head=jnp.where(
            store_when, (slot + 1) % store.pay_valid.shape[0], slot
        ).astype(jnp.int32),
        own_id=scat(own_id0, cand_id),
        peer_type=scat(store.peer_type, cand_type),
        pay_slot=scat(store.pay_slot, jnp.full_like(cand_idx, slot)),
        peer_idx=scat(store.peer_idx, cand_idx),
        uav_id=scat(store.uav_id, jnp.full_like(cand_idx, uav_id)),
    )


class HarvestedWork(NamedTuple):
    """Fixed-budget match work emitted for one visual update."""

    # joint-MSCKF per own frame.msckf row: (Km, P) store-row references
    msckf_rows: jnp.ndarray  # (Km, P) int32 match-table row, -1 = none
    msckf_matched: jnp.ndarray  # (Km, P) bool
    # dead-track (short) matches, same layout over frame.short rows
    short_rows: jnp.ndarray  # (Ks, P)
    short_matched: jnp.ndarray  # (Ks, P)
    # SLAM-SLAM upgrades: own feature slot x stored peer feature
    slam_own_idx: jnp.ndarray  # (Q,) int32 own SLAM slot
    slam_rows: jnp.ndarray  # (Q,) int32 match-table row
    slam_matched: jnp.ndarray  # (Q,) bool


def update_and_harvest(
    store: MatchStore,
    slots,  # tm.TrackSlots AFTER manage_tracks for this frame
    frame,  # tm.FrameTracks for this frame
    max_peers: int,
) -> tuple[MatchStore, HarvestedWork]:
    """Reference ``updateOppMatches`` + match consumption selection.

    Joins the match table against this frame's track classification:
      * rows whose own id is in ``frame.msckf_id`` -> joint-MSCKF work
      * rows whose own id is in ``frame.short_id`` -> short joint work
      * rows whose own id is in ``slots.slam_id`` and peer side is SLAM ->
        SLAM-SLAM work
      * rows whose own id is live OPP stay; everything else is discarded.
    Consumed rows are freed. Returns (store, work).
    """
    q = store.own_id.shape[0]
    p = max_peers
    row_live = (store.own_id >= 0) & store.pay_valid[store.pay_slot]

    def join(ids):  # (A,) ids -> per (A, Q) hit matrix
        return (ids[:, None] == store.own_id[None, :]) & row_live[None, :] & (
            ids[:, None] >= 0
        )

    # --- joint-MSCKF work (peer side must be a collaborative track) ------
    def topk_rows(hit):  # (A, Q) -> (A, P) row indices + matched
        h = hit & (store.peer_type[None, :] == PEER_COLLAB)
        order = jnp.argsort(~h, axis=1, stable=True)[:, :p]  # (A, P)
        matched = jnp.take_along_axis(h, order, axis=1)
        return jnp.where(matched, order, -1).astype(jnp.int32), matched

    msckf_hit = join(frame.msckf_id)
    msckf_rows, msckf_matched = topk_rows(msckf_hit)
    short_hit = join(frame.short_id)
    short_rows, short_matched = topk_rows(short_hit)

    # --- SLAM-SLAM upgrades ----------------------------------------------
    slam_hit = join(slots.slam_id) & (store.peer_type[None, :] == PEER_SLAM)
    # one row per match-table entry: own slot = argmax over the hit column
    slam_matched = slam_hit.any(axis=0)  # (Q,)
    slam_own_idx = jnp.argmax(slam_hit, axis=0).astype(jnp.int32)  # (Q,)
    slam_rows = jnp.arange(q, dtype=jnp.int32)

    # --- discard / free ----------------------------------------------------
    consumed_rows = jnp.zeros((q,), bool)
    for rows_m, m_m in ((msckf_rows, msckf_matched), (short_rows, short_matched)):
        flat_rows = rows_m.reshape(-1)
        flat_ok = m_m.reshape(-1)
        consumed_rows = consumed_rows | (
            jnp.zeros((q + 1,), bool)
            .at[jnp.where(flat_ok, flat_rows, q)]
            .set(True)[:q]
        )
    consumed_rows = consumed_rows | slam_matched

    # still-alive own ids: live OPP tracks (reference keeps matches whose
    # own track is still opportunistic, discards the rest) plus this
    # frame's in-flight SLAM promotions (their feature slot exists only
    # after init; the SLAM-SLAM upgrade then fires next frame)
    alive = (store.own_id[None, :] == slots.opp_id[:, None]) & (
        slots.opp_id[:, None] >= 0
    )
    alive_new = (store.own_id[None, :] == frame.new_id[:, None]) & (
        frame.new_id[:, None] >= 0
    )
    keep = row_live & (alive.any(axis=0) | alive_new.any(axis=0)) & ~consumed_rows
    own_id1 = jnp.where(keep, store.own_id, -1)

    store = dataclasses.replace(store, own_id=own_id1)
    work = HarvestedWork(
        msckf_rows=msckf_rows,
        msckf_matched=msckf_matched,
        short_rows=short_rows,
        short_matched=short_matched,
        slam_own_idx=slam_own_idx,
        slam_rows=slam_rows,
        slam_matched=slam_matched,
    )
    return store, work


def gather_peer_tracks(store: MatchStore, rows: jnp.ndarray, matched: jnp.ndarray):
    """Gather per-own-track peer data for :func:`apply_joint_msckf_ci_pairs`.

    rows/matched: (K, P) match-table references from HarvestedWork.
    Returns (p_arr (K,P,M,3), q_arr (K,P,M,4), pose_cov (K,P,6M,6M),
    obs (K,P,M,2), mask (K,P,M)).
    """
    safe = jnp.maximum(rows, 0)
    slot = store.pay_slot[safe]  # (K, P)
    tidx = store.peer_idx[safe]  # (K, P)
    p_arr = store.pay.p_arr[slot]  # (K, P, M, 3)
    q_arr = store.pay.q_arr[slot]
    cov = store.pay.pose_cov[slot]
    obs = store.pay.trk_obs[slot, tidx]  # (K, P, M, 2)
    mask = store.pay.trk_mask[slot, tidx] & matched[..., None]
    return p_arr, q_arr, cov, obs, mask


def gather_peer_slam(store: MatchStore, work: HarvestedWork):
    """Gather the peer payload data for SLAM-SLAM upgrade matches.

    Returns per match-table row: (own_idx (Q,), peer_feat_idx (Q,),
    p_arr (Q,M,3), q_arr (Q,M,4), f_arr (Q,N,3), anchor (Q,N),
    lm_cov (Q,N,3,3), valid (Q,))."""
    slot = store.pay_slot  # (Q,)
    return (
        work.slam_own_idx,
        store.peer_idx,
        store.pay.p_arr[slot],
        store.pay.q_arr[slot],
        store.pay.f_arr[slot],
        store.pay.anchor_idx[slot],
        store.pay.lm_cov[slot],
        work.slam_matched,
    )
