"""Collaborative (multi-agent) fusion rounds.

The reference's decentralized exchange (SURVEY §2.9.5): each agent ships a
SimpleState payload to peers (full-map broadcast mode, ``getDataToSend``)
and fuses received states via SLAM-SLAM covariance intersection
(``VIO::processOtherMeasurements`` -> ``Ekf::processOthersMeasurement`` ->
``Updater::collaborativeUpdate``).

Design: payloads of all agents are one stacked pytree. On one device the
round is a vmap over agents; over a mesh the payload stack is an
all_gather over the ``agents`` axis and the per-agent fusion stays local.
GT_DEBUG landmark matching stands in for descriptor place recognition
(config 4 of BASELINE.json); the descriptor path plugs into the same match
interface.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ekf import buffer as rb
from ..ekf import ekf as ekf_mod
from ..parallel.payload import AgentPayload, make_payload, slam_landmarks_world
from ..place_recognition.gt_matching import match_landmarks
from ..vio.updates import multi_slam
from ..vio import vio as vio_mod


class CollabConfig(NamedTuple):
    sigma_landmark: float = 0.1
    ci_slam_w: float = 0.01  # weight given to the peer (reference ci_slam_w)
    gt_match_dist: float = 0.5  # GT_DEBUG proximity gate [m]
    match_budget: int = 10  # SLAM-SLAM matches per peer
    # descriptor path (reference pr_desc_* params)
    desc_ratio_thr: float = 0.8
    desc_abs_thr: float = 60.0
    # request-response policy (reference pr_score_thr)
    pr_score_thr: float = 0.3
    # essential-matrix RANSAC gate on descriptor matches, threshold in
    # normalized-coordinate units (reference findEssentialMat verification,
    # place_recognition.cpp:269-283); <= 0 disables
    pr_ransac_thr: float = 0.01
    # pairwise-distance consistency gate on matched SLAM landmarks [m]:
    # |d(own_i, own_j) - d(peer_i', peer_j')| < tol for at least half the
    # matched set. Invariant to each agent's global drift (it cancels in
    # relative distances), so it rejects aliased descriptor associations
    # that survive the appearance + epipolar gates. <= 0 disables.
    geom_consistency_tol: float = 0.0
    # cross-agent MSCKF CI weight (reference ci_msckf_w)
    ci_msckf_w: float = 0.01
    max_peers: int = 2  # joint-MSCKF peer budget per track
    # per-round peer budget: each requester consumes at most this many
    # received keyframes, the TOP-K by VLAD score (0 = unlimited). The
    # reference's once-per-peer served set (database.cpp:30-50) bounds
    # repeat traffic but not fan-in; at fleet scale every-peer fusion is
    # O(A^2) work AND inconsistency pressure — K highest-similarity peers
    # bound both (exchange work grows O(A*K)).
    top_k_peers: int = 0
    # ablation switches for the persistent match-store paths (static —
    # each combination is its own jit variant); used to bisect which
    # exchange stream breaks consistency in end-to-end replays
    use_stored_slam: bool = True  # stored SLAM-SLAM upgrades
    use_stored_shortci: bool = True  # matched-dead-track joint short CI
    use_stored_msckf: bool = True  # stored joint-MSCKF CI
    record_opp_matches: bool = True  # record OPP matches on receive
    # SLAM-SLAM re-fusion cooldown: once an own landmark has been CI-fused
    # against a given peer, skip re-fusing that landmark for this many
    # subsequent receives from the same peer (0 = off). Successive
    # keyframes from one peer carry nearly identical landmark estimates;
    # re-fusing them every receive extracts the same information
    # repeatedly (Kalman-style info adds linearly even under CI weighting)
    # and makes the collaborative filter overconfident (round-2 replay:
    # collab NEES 6.4 on 3 dof). The gate is keyed by slam_id, so a slot
    # that re-initializes a NEW landmark fuses immediately.
    refuse_cooldown: int = 0


def extract_payload(params: vio_mod.VioParams, fs) -> AgentPayload:
    """Snapshot the anchor-state vision/covariance for broadcast."""
    t = rb.times(fs.buffer)[fs.anchor_buf_idx]
    return make_payload(params.cfg.dims, t, fs.vision, fs.cov)


def fuse_with_peer(
    params: vio_mod.VioParams,
    ccfg: CollabConfig,
    fs,
    peer: AgentPayload,
    peer_valid,
):
    """Reference ``processOtherMeasurements`` (SLAM-SLAM path): match peer
    landmarks, CI-fuse at the closest buffer state, repropagate."""
    dims = params.cfg.dims

    def update_fn(core, vision, cov, aux):
        own_lm, own_valid = slam_landmarks_world(dims, vision)
        own_idx, other_idx, mvalid = match_landmarks(
            own_lm,
            own_valid,
            peer.landmarks,
            peer.landmark_valid,
            ccfg.gt_match_dist,
            ccfg.match_budget,
        )
        mvalid = mvalid & peer_valid
        core, vision, cov, n_app, _ = multi_slam.apply_matches(
            dims, core, vision, cov,
            peer.p_arr, peer.q_arr, peer.f_arr, peer.anchor_idx, peer.lm_cov,
            own_idx, other_idx, mvalid,
            ccfg.sigma_landmark, ccfg.ci_slam_w,
        )
        return core, vision, cov, aux + n_app

    # fuse at the receiver's NEWEST buffer state, not at the payload's
    # snapshot time: the SLAM-SLAM residual compares two static world
    # landmark estimates, so the peer snapshot's age is irrelevant to the
    # receiver's linearization point (reference processOtherMeasurements
    # updates the current state, vio.cpp:498-570). Anchoring at peer.time
    # silently dropped EVERY fusion of a served keyframe — snapshots are
    # seconds old, far outside the max_update_lag window.
    meas_time = rb.times(fs.buffer)[fs.head]
    fs, n_applied, ok = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, meas_time, update_fn, jnp.asarray(0, jnp.int32)
    )
    return fs, n_applied


def fuse_with_peer_desc(
    params: vio_mod.VioParams,
    ccfg: CollabConfig,
    fs,
    slots,
    peer: AgentPayload,
    peer_valid,
    recency=None,
):
    """Descriptor-based SLAM-SLAM fusion (reference
    ``PlaceRecognition::findCorrespondences`` SLAM path +
    ``processOtherMeasurements``): BF-Hamming kNN(2) with ratio/absolute
    gates on the SLAM-track descriptors, then CI fusion of matched
    landmarks. (The chi2(3) gate inside apply_matches subsumes the
    essential-matrix geometric verification for state-space consistency.)

    ``recency`` (used when ``ccfg.refuse_cooldown > 0``): a per-THIS-peer
    tuple (last_id (n_slam,), last_cnt (n_slam,), cnt scalar) — the
    slam_id last fused per own slot, the receive counter at that fusion,
    and the current receive counter. Returns (fs, n_applied, recency')."""
    from ..place_recognition.descriptors import knn2_match

    dims = params.cfg.dims
    use_cooldown = ccfg.refuse_cooldown > 0 and recency is not None
    if recency is None:
        nslam = slots.slam_id.shape[0]
        recency = (
            jnp.full((nslam,), -1, jnp.int32),
            jnp.full((nslam,), -(10**9), jnp.int32),
            jnp.asarray(0, jnp.int32),
        )

    def update_fn(core, vision, cov, aux):
        other_idx, ok = knn2_match(
            slots.slam_desc,
            slots.slam_desc_valid,
            peer.slam_desc,
            peer.slam_desc_valid,
            ccfg.desc_ratio_thr,
            ccfg.desc_abs_thr,
        )
        if ccfg.pr_ransac_thr > 0:
            # geometric verification: epipolar RANSAC over the matched
            # last observations (normalized coords -> F == E up to K)
            from ..ops.ransac import fundamental_ransac

            m = dims.n_poses
            own_pts = slots.slam_obs[:, m - 1]
            peer_pts = peer.slam_obs[other_idx]
            # fresh hypothesis set per call: fold the peer snapshot time and
            # the receiver's buffer head into the key (a fixed key would
            # reuse one degenerate hypothesis set forever)
            key = jax.random.fold_in(
                jax.random.fold_in(
                    jax.random.PRNGKey(7),
                    jnp.asarray(peer.time, jnp.float32).view(jnp.int32),
                ),
                fs.head,
            )
            inl, _ = fundamental_ransac(
                own_pts, peer_pts, ok, key, ccfg.pr_ransac_thr,
            )
            ok = ok & inl
        if ccfg.geom_consistency_tol > 0:
            own_lm, own_lm_valid = slam_landmarks_world(dims, vision)
            ok = ok & own_lm_valid & peer.landmark_valid[other_idx]
            peer_lm = peer.landmarks[other_idx]
            d_own = jnp.linalg.norm(
                own_lm[:, None, :] - own_lm[None, :, :], axis=-1
            )
            d_peer = jnp.linalg.norm(
                peer_lm[:, None, :] - peer_lm[None, :, :], axis=-1
            )
            cons = (
                (jnp.abs(d_own - d_peer) < ccfg.geom_consistency_tol)
                & ok[None, :]
                & ok[:, None]
                & ~jnp.eye(own_lm.shape[0], dtype=bool)
            )
            support = jnp.sum(cons, axis=1)
            n_ok = jnp.sum(ok)
            # each kept match must be consistent with at least half of the
            # other matches (and at least one)
            need = jnp.maximum(1, (n_ok - 1) // 2)
            ok = ok & (support >= need)
        if use_cooldown:
            last_id, last_cnt, cnt = aux[1]
            fresh = (slots.slam_id != last_id) | (
                cnt - last_cnt >= ccfg.refuse_cooldown
            )
            ok = ok & fresh
        n = dims.n_features
        budget = ccfg.match_budget
        order = jnp.argsort(~ok, stable=True)[:budget]
        own_idx = order.astype(jnp.int32)
        mvalid = ok[order] & peer_valid
        core, vision, cov, n_app, applied = multi_slam.apply_matches(
            dims, core, vision, cov,
            peer.p_arr, peer.q_arr, peer.f_arr, peer.anchor_idx, peer.lm_cov,
            own_idx, other_idx[order], mvalid,
            ccfg.sigma_landmark, ccfg.ci_slam_w,
        )
        if use_cooldown:
            last_id = last_id.at[own_idx].set(
                jnp.where(applied, slots.slam_id[own_idx], last_id[own_idx])
            )
            last_cnt = last_cnt.at[own_idx].set(
                jnp.where(applied, cnt, last_cnt[own_idx])
            )
            rec1 = (last_id, last_cnt, cnt)
        else:
            rec1 = aux[1]
        return core, vision, cov, (aux[0] + n_app, rec1)

    # current-state fusion (see fuse_with_peer): a served keyframe's
    # snapshot time is stale by construction; the landmark residual does
    # not depend on it
    meas_time = rb.times(fs.buffer)[fs.head]
    fs, (n_applied, recency1), ok = ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, meas_time, update_fn,
        (jnp.asarray(0, jnp.int32), recency),
    )
    return fs, n_applied, recency1


def collaborative_round(params: vio_mod.VioParams, ccfg: CollabConfig, fs_stack):
    """One full-map exchange round for A stacked agents (single host/chip
    form: vmap over agents; all payloads visible in the stacked pytree).

    Returns (fs_stack, n_matches (A, A))."""
    payloads = jax.vmap(lambda fs: extract_payload(params, fs))(fs_stack)
    a = payloads.time.shape[0]

    def one_agent(fs, my_id):
        def peer_step(carry, b):
            fs = carry
            peer = jax.tree.map(lambda x: x[b], payloads)
            fs, n = fuse_with_peer(params, ccfg, fs, peer, b != my_id)
            return fs, n

        fs, ns = jax.lax.scan(peer_step, fs, jnp.arange(a))
        return fs, ns

    return jax.vmap(one_agent)(fs_stack, jnp.arange(a))


collaborative_round_jit = jax.jit(collaborative_round, static_argnums=(0, 1))


def collaborative_msckf_round(
    params: vio_mod.VioParams, ccfg: CollabConfig, fs_stack, slots_stack
):
    """Cross-agent joint-MSCKF CI round: each agent's long opportunistic
    tracks are descriptor-matched against every peer's collaborative track
    set and jointly triangulated + CI-fused (reference MULTI_UAV MSCKF
    path). Outside the visual update the own-track MSCKF gate is
    approximated by track validity. Returns (fs_stack, n_applied (A,))."""
    from ..vio.updates import msckf_multi

    a = fs_stack.head.shape[0]
    p_max = ccfg.max_peers
    payloads = jax.vmap(lambda fs, sl: extract_payload_desc(params, fs, sl))(
        fs_stack, slots_stack
    )

    def one_agent(fs, slots, my_id):
        own = jax.tree.map(lambda x: x[my_id], payloads)
        # first p_max peers != self (deterministic selection)
        order = jnp.argsort(jnp.where(jnp.arange(a) == my_id, a + 1, jnp.arange(a)))
        peer_ids = order[:p_max]
        peer_valid = peer_ids != my_id
        peer = jax.tree.map(lambda x: x[peer_ids], payloads)

        def update_fn(core, vision, cov, aux):
            core, vision, cov, n = msckf_multi.apply_joint_msckf_ci(
                params.cfg.dims, core, vision, cov,
                own.trk_obs, own.trk_mask,
                own.trk_desc_valid,  # own gate approximation
                own.trk_desc, own.trk_desc_valid,
                peer.p_arr, peer.q_arr, peer.pose_cov,
                peer.trk_obs, peer.trk_mask, peer.trk_desc,
                peer.trk_desc_valid, peer_valid,
                params.cfg.sigma_img, ccfg.ci_msckf_w,
                oc=params.cfg.obs_constrained,
                desc_abs_thr=ccfg.desc_abs_thr,
            )
            return core, vision, cov, aux + n

        fs, n_applied, _ = ekf_mod.process_update_aux_impl(
            params.ekf_params, fs, own.time, update_fn, jnp.asarray(0, jnp.int32)
        )
        return fs, n_applied

    return jax.vmap(one_agent)(fs_stack, slots_stack, jnp.arange(a))


# ---------------------------------------------------------------------------
# request-response policy (MULTI_UAV + REQUEST_COMM, SURVEY §3.4)
# ---------------------------------------------------------------------------


def extract_payload_desc(
    params: vio_mod.VioParams, fs, slots, n_collab_tracks: int = 8
) -> AgentPayload:
    """Payload incl. SLAM-track descriptors + last observations + the
    top collaborative (opportunistic) tracks for cross-agent MSCKF."""
    t = rb.times(fs.buffer)[fs.anchor_buf_idx]
    m = params.cfg.dims.n_poses
    # longest opp tracks with valid descriptors
    key = jnp.where(
        (slots.opp_id >= 0) & slots.opp_desc_valid,
        slots.opp_length.astype(fs.cov.dtype),
        -jnp.inf,
    )
    sel = jnp.argsort(-key, stable=True)[:n_collab_tracks]
    sel_valid = (slots.opp_id[sel] >= 0) & slots.opp_desc_valid[sel]
    return make_payload(
        params.cfg.dims, t, fs.vision, fs.cov,
        slam_desc=slots.slam_desc,
        slam_desc_valid=slots.slam_desc_valid,
        slam_obs=slots.slam_obs[:, m - 1],
        trk_obs=slots.opp_obs[sel],
        trk_mask=slots.opp_mask[sel] & sel_valid[:, None],
        trk_desc=slots.opp_desc[sel],
        trk_desc_valid=sel_valid,
        n_collab_tracks=n_collab_tracks,
        trk_id=jnp.where(sel_valid, slots.opp_id[sel], -1),
        slam_id=slots.slam_id,
    )


def should_select_keyframe(
    params: vio_mod.VioParams, fs, slots, last_kf_pos, frames_since
):
    """Keyframe selection heuristic (reference ``VioUpdater::postUpdate``
    REQUEST_COMM branch, vio_updater.cpp:451-484): >=10 frames since last,
    parallax/median-depth ratio > 0.15, more than 10 live tracks."""
    from ..ekf import buffer as rb

    core = rb.get_slot(fs.buffer, fs.anchor_buf_idx)
    vision = fs.vision
    rho = vision.f_arr[:, 2]
    # reference gate: signed rho > 0.001 (< 0.001 -> farther than 1000 m),
    # depth averaged over ALL N feature slots (vio_updater.cpp:456-464 —
    # the variable is *named* med_depth but is a sum/N average)
    usable = (rho > 1e-3) & vision.feature_mask(params.cfg.dims)
    depth_sum = jnp.sum(jnp.where(usable, 1.0 / jnp.maximum(rho, 1e-3), 0.0))
    med_depth = depth_sum / jnp.maximum(vision.f_arr.shape[0], 1)
    diff = jnp.linalg.norm(core.p - last_kf_pos)
    n_tracks = jnp.sum(slots.slam_id >= 0) + jnp.sum(slots.opp_id >= 0)
    return (
        (frames_since > 10)
        & (med_depth > 0.0)
        & (diff / jnp.maximum(med_depth, 1e-6) > 0.15)
        & (n_tracks > 10)
    )


class KfMeta(NamedTuple):
    """Keyframe-selection bookkeeping (reference ``VioUpdater`` members
    ``last_pose_`` / ``frames_min_distance_``, vio_updater.cpp:451-484)."""

    last_kf_pos: jnp.ndarray  # (3,)
    frames_since: jnp.ndarray  # int32

    @staticmethod
    def zero(dtype=jnp.float32) -> "KfMeta":
        return KfMeta(
            last_kf_pos=jnp.zeros((3,), dtype),
            frames_since=jnp.asarray(0, jnp.int32),
        )


def maybe_add_keyframe(
    params: vio_mod.VioParams,
    db_dims,
    words: jnp.ndarray,
    fs,
    slots,
    db,
    kf_meta: KfMeta,
    enabled=True,
):
    """Post-visual-update keyframe step (reference ``VioUpdater::postUpdate``
    REQUEST_COMM branch, vio_updater.cpp:451-484): evaluate the selection
    heuristic; on selection, snapshot the current state+tracks as a keyframe
    into the ring DB (``Tracker::addKeyframe`` -> ``Database::addKeyframe``)
    and reset the distance/frame counters.

    Returns (db, kf_meta, selected)."""
    from ..place_recognition import database as db_mod

    sel = should_select_keyframe(
        params, fs, slots, kf_meta.last_kf_pos, kf_meta.frames_since
    ) & jnp.asarray(enabled)
    payload = extract_payload_desc(params, fs, slots)
    db_new = db_mod.add_keyframe(db_dims, db, payload, words)
    db = jax.tree.map(lambda a, b: jnp.where(sel, a, b), db_new, db)
    core = rb.get_slot(fs.buffer, fs.anchor_buf_idx)
    step = jnp.where(jnp.asarray(enabled), 1, 0)  # counters advance only on
    # applied visual updates (reference increments frames_min_distance_
    # once per postUpdate, vio_updater.cpp:483)
    kf_meta = KfMeta(
        last_kf_pos=jnp.where(sel, core.p, kf_meta.last_kf_pos),
        frames_since=jnp.where(sel, 0, kf_meta.frames_since + step).astype(jnp.int32),
    )
    return db, kf_meta, sel


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def process_matches_collab(
    params: vio_mod.VioParams,
    ccfg: CollabConfig,
    db_dims,
    words: jnp.ndarray,
    fs,
    slots,
    store,
    db,
    kf_meta: KfMeta,
    meas_time,
    meas,
):
    """One collaborative visual update: stored cross-agent matches are
    upgraded/consumed inside the update (``updateOppMatches`` semantics),
    then the REQUEST_COMM keyframe-selection heuristic runs post-update
    (reference ``VioUpdater::postUpdate``, vio_updater.cpp:425-484).

    Returns (fs, slots, store, db, kf_meta, applied, kf_selected, n_collab).
    """
    fs, (slots, store, n_collab), applied = visual_update_with_store(
        params, ccfg, fs, slots, store, meas_time, meas
    )
    db, kf_meta, sel = maybe_add_keyframe(
        params, db_dims, words, fs, slots, db, kf_meta, enabled=applied
    )
    return fs, slots, store, db, kf_meta, applied, sel, n_collab


def payload_nbytes(payload: AgentPayload) -> int:
    """Wire size of one keyframe payload (the heavy message; static)."""
    return sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree.leaves(payload)
    )


def vlad_nbytes(words: jnp.ndarray) -> int:
    """Wire size of one VLAD query (the cheap message: W x 32 bytes)."""
    return int(words.shape[0]) * 32


def query_vlad(words: jnp.ndarray, slots) -> jnp.ndarray:
    """Requester side of ``VIO::getDescriptors`` (vio.cpp:455-460): VLAD of
    the current frame's descriptors (SLAM + opportunistic tracks)."""
    from ..place_recognition.vlad import compute_vlad

    desc = jnp.concatenate([slots.slam_desc, slots.opp_desc], axis=0)
    valid = jnp.concatenate([slots.slam_desc_valid, slots.opp_desc_valid], axis=0)
    return compute_vlad(words, desc, valid)


def request_response_round(
    params: vio_mod.VioParams,
    ccfg: CollabConfig,
    words: jnp.ndarray,
    fs_stack,
    slots_stack,
    db_stack,
):
    """One VLAD request-response exchange for A stacked agents.

    Each agent broadcasts its query VLAD (cheap: W x 32 bytes); each
    responder answers each peer with its best unserved keyframe above
    ``pr_score_thr`` (heavy payload shipped only on a hit — the 89%%
    bandwidth-saving policy); requesters fuse received keyframes with
    descriptor matching + CI. With ``ccfg.top_k_peers > 0`` each
    requester consumes only its K best-scoring responses.

    Returns (fs_stack, db_stack, hits (A requesters, A responders)).
    """
    from ..place_recognition import database as db_mod

    a = fs_stack.head.shape[0]
    vlads = jax.vmap(lambda s: query_vlad(words, s))(slots_stack)  # (A, W, 32)

    # responders answer every requester (scan mutates served flags)
    def respond(db, my_id):
        def one_req(db, req_id):
            idx, found, score, db = db_mod.find_candidate_scored(
                db, req_id, vlads[req_id], ccfg.pr_score_thr
            )
            found = found & (req_id != my_id)
            return db, (idx, found, score)

        db, (idxs, founds, scores) = jax.lax.scan(one_req, db, jnp.arange(a))
        kfs = jax.vmap(lambda i: db_mod.get_keyframe(db, i))(idxs)
        return db, kfs, founds, scores

    db_stack, kf_grid, hit_grid, score_grid = jax.vmap(respond)(
        db_stack, jnp.arange(a)
    )
    # kf_grid[b, a] = keyframe payload responder b ships to requester a
    # hit_grid[b, a], score_grid[b, a]

    sel, sel_valid = top_k_select(hit_grid.T, score_grid.T, ccfg.top_k_peers)
    k_eff = sel.shape[1]

    def consume(fs, slots, my_id):
        def one_peer(fs, kk):
            b = sel[my_id, kk]
            kf = jax.tree.map(lambda x: x[b, my_id], kf_grid)
            fs, n, _ = fuse_with_peer_desc(
                params, ccfg, fs, slots, kf, sel_valid[my_id, kk]
            )
            return fs, n

        fs, ns = jax.lax.scan(one_peer, fs, jnp.arange(k_eff))
        return fs, ns

    fs_stack, n_matches = jax.vmap(consume)(
        fs_stack, slots_stack, jnp.arange(a)
    )
    hits_kept = (
        jnp.zeros((a, a), jnp.int32)
        .at[jnp.arange(a)[:, None], sel]
        .max(sel_valid.astype(jnp.int32))
        > 0
    )
    return fs_stack, db_stack, hits_kept, n_matches


def top_k_select(hits: jnp.ndarray, scores: jnp.ndarray, k: int):
    """Each requester's K best-scoring responders — as GATHER indices, so
    the heavy consumption (descriptor kNN + CI) runs O(K) per agent, not
    O(A) masked (a vmapped lax.cond still executes both branches).

    hits/scores: (A requesters, P responders). k <= 0 keeps all P.
    Returns (sel (A, K) responder indices, valid (A, K))."""
    a, p = hits.shape
    if k <= 0 or k >= p:
        return (
            jnp.broadcast_to(jnp.arange(p, dtype=jnp.int32), (a, p)),
            hits,
        )
    sc = jnp.where(hits, scores, -jnp.inf)
    order = jnp.argsort(-sc, axis=1)[:, :k].astype(jnp.int32)  # (A, K)
    valid = jnp.take_along_axis(hits, order, axis=1)
    return order, valid


# ---------------------------------------------------------------------------
# persistent match store integration (reference PlaceRecognition match
# containers + updateOppMatches; see parallel/match_store.py)
# ---------------------------------------------------------------------------


def receive_and_record(
    params: vio_mod.VioParams,
    ccfg: CollabConfig,
    fs,
    slots,
    store,
    payload: AgentPayload,
    uav_id,
    payload_valid=True,
    recency=None,
):
    """Reference ``VIO::processOtherMeasurements`` with persistence:
    SLAM-SLAM matches are CI-fused immediately (as in the reference's
    ``collaborativeUpdate``); own-OPP descriptor matches against the
    peer's collaborative/SLAM sets are recorded in the match store and
    consumed by later visual updates once the own track matures
    (``updateOppMatches`` upgrade semantics). ``recency`` is the per-peer
    re-fusion cooldown state (see :func:`fuse_with_peer_desc`)."""
    from . import match_store as ms_mod

    fs, n, recency1 = fuse_with_peer_desc(
        params, ccfg, fs, slots, payload, payload_valid, recency=recency
    )
    if ccfg.record_opp_matches:
        store = ms_mod.record(
            store, slots, payload, uav_id,
            ccfg.desc_ratio_thr, ccfg.desc_abs_thr, store_when=payload_valid,
            ransac_thr=ccfg.pr_ransac_thr,
        )
    return fs, store, n, recency1


receive_and_record_jit = jax.jit(receive_and_record, static_argnums=(0, 1))


def visual_update_with_store(params: vio_mod.VioParams, ccfg: CollabConfig,
                             fs, slots, store, meas_time, meas):
    """Visual update that also upgrades/consumes stored cross-agent
    matches (joint-MSCKF CI, SLAM-SLAM upgrades, matched-dead-track CI).

    Returns (fs, (slots, store, n_collab), applied)."""
    from ..vio import pipeline

    def update_fn(core, vision, cov, aux):
        slots, store, _ = aux
        core, vision, cov, slots, store, n_collab = pipeline.visual_update(
            params.cfg, core, vision, cov, slots, meas, store=store,
            collab_cfg=ccfg,
        )
        return core, vision, cov, (slots, store, n_collab)

    return ekf_mod.process_update_aux_impl(
        params.ekf_params, fs, meas_time, update_fn,
        (slots, store, jnp.asarray(0, jnp.int32)),
    )


visual_update_with_store_jit = jax.jit(
    visual_update_with_store, static_argnums=(0, 1)
)
