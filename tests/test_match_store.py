"""Persistent cross-agent match store (reference PlaceRecognition
``msckf_matches_``/``slam_matches_``/``opp_matches_`` + ``updateOppMatches``,
``place_recognition.cpp:525-675``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.ekf.state import StateDims, VisionState
from x_multi_agent_jax.parallel import collab, match_store as ms
from x_multi_agent_jax.parallel.payload import make_payload
from x_multi_agent_jax.vio import track_manager as tm

from tests.test_collab import CCFG, PARAMS, TRACKS, DIMS, run_agent

SDIMS = ms.StoreDims(n_payloads=2, n_matches=8, max_peers=1)


def _slots_with_opp(rng, n_opp_active=3):
    slots = tm.TrackSlots.zero(TRACKS, jnp.float64)
    desc = rng.integers(0, 256, (TRACKS.n_opp, 32)).astype(np.uint8)
    opp_id = np.full(TRACKS.n_opp, -1, np.int32)
    opp_id[:n_opp_active] = np.arange(100, 100 + n_opp_active)
    import dataclasses

    slots = dataclasses.replace(
        slots,
        opp_id=jnp.asarray(opp_id),
        opp_desc=jnp.asarray(desc),
        opp_desc_valid=jnp.asarray(opp_id >= 0),
        opp_length=jnp.asarray(np.where(opp_id >= 0, 5, 0).astype(np.int32)),
    )
    return slots, desc


def _payload(rng, collab_desc, slam_desc):
    vision = VisionState.zero(DIMS, jnp.float64)
    cov = jnp.eye(DIMS.d, dtype=jnp.float64)
    kt = collab_desc.shape[0]
    m = DIMS.n_poses
    return make_payload(
        DIMS, 1.0, vision, cov,
        slam_desc=jnp.asarray(slam_desc),
        slam_desc_valid=jnp.ones((slam_desc.shape[0],), bool),
        slam_obs=jnp.zeros((slam_desc.shape[0], 2), jnp.float64),
        trk_obs=jnp.asarray(rng.normal(size=(kt, m, 2)) * 0.1),
        trk_mask=jnp.ones((kt, m), bool),
        trk_desc=jnp.asarray(collab_desc),
        trk_desc_valid=jnp.ones((kt,), bool),
        n_collab_tracks=kt,
    )


def _empty_frame(dtype=jnp.float64):
    km, ks, kn = TRACKS.n_msckf, TRACKS.n_short, TRACKS.n_new_slam
    m, n = TRACKS.n_poses, TRACKS.n_slam
    z = jnp.zeros
    return tm.FrameTracks(
        slam_has_obs=z((n,), bool),
        lost_slam=z((n,), bool),
        msckf_obs=z((km, m, 2), dtype),
        msckf_mask=z((km, m), bool),
        msckf_valid=z((km,), bool),
        msckf_id=jnp.full((km,), -1, jnp.int32),
        short_obs=z((ks, m, 2), dtype),
        short_mask=z((ks, m), bool),
        short_valid=z((ks,), bool),
        short_id=jnp.full((ks,), -1, jnp.int32),
        new_obs=z((kn, m, 2), dtype),
        new_mask=z((kn, m), bool),
        new_valid=z((kn,), bool),
        new_is_msckf=z((kn,), bool),
        new_id=jnp.full((kn,), -1, jnp.int32),
        new_length=z((kn,), jnp.int32),
        new_desc=z((kn, 32), jnp.uint8),
        new_desc_valid=z((kn,), bool),
        new_tile=jnp.full((kn,), -1, jnp.int32),
    )


def test_record_and_dedup(rng):
    slots, opp_desc = _slots_with_opp(rng)
    # peer collab track 0 matches own opp track 0; peer SLAM feature 1
    # matches own opp track 1
    collab_desc = rng.integers(0, 256, (4, 32)).astype(np.uint8)
    slam_desc = rng.integers(0, 256, (TRACKS.n_slam, 32)).astype(np.uint8)
    collab_desc[0] = opp_desc[0]
    slam_desc[1] = opp_desc[1]
    payload = _payload(rng, collab_desc, slam_desc)

    store = ms.MatchStore.zero(DIMS, SDIMS, n_collab_tracks=4, dtype=jnp.float64)
    store = ms.record(store, slots, payload, 7, 0.8, 60.0)

    own_ids = np.array(store.own_id)
    assert 100 in own_ids and 101 in own_ids
    row0 = int(np.argmax(own_ids == 100))
    row1 = int(np.argmax(own_ids == 101))
    assert int(store.peer_type[row0]) == ms.PEER_COLLAB
    assert int(store.peer_idx[row0]) == 0
    assert int(store.peer_type[row1]) == ms.PEER_SLAM
    assert int(store.peer_idx[row1]) == 1
    assert int(store.uav_id[row0]) == 7

    # re-recording the same payload must not duplicate
    n_before = int(np.sum(np.array(store.own_id) >= 0))
    store2 = ms.record(store, slots, payload, 7, 0.8, 60.0)
    assert int(np.sum(np.array(store2.own_id) >= 0)) == n_before


def test_upgrade_and_discard(rng):
    slots, opp_desc = _slots_with_opp(rng, n_opp_active=4)
    collab_desc = rng.integers(0, 256, (4, 32)).astype(np.uint8)
    slam_desc = rng.integers(0, 256, (TRACKS.n_slam, 32)).astype(np.uint8)
    collab_desc[0] = opp_desc[0]  # own 100 x peer collab
    collab_desc[1] = opp_desc[2]  # own 102 x peer collab
    slam_desc[3] = opp_desc[1]  # own 101 x peer slam
    collab_desc[2] = opp_desc[3]  # own 103 x peer collab (track will die)
    payload = _payload(rng, collab_desc, slam_desc)
    store = ms.MatchStore.zero(DIMS, SDIMS, n_collab_tracks=4, dtype=jnp.float64)
    store = ms.record(store, slots, payload, 7, 0.8, 60.0)
    assert int(np.sum(np.array(store.own_id) >= 0)) == 4

    # frame: own 100 selected as MSCKF; own 103 died (gone from opp pool);
    # own 101 was promoted to SLAM slot 2; own 102 stays opportunistic
    import dataclasses

    frame = _empty_frame()
    frame = dataclasses.replace(
        frame,
        msckf_id=frame.msckf_id.at[0].set(100),
        msckf_valid=frame.msckf_valid.at[0].set(True),
    )
    slam_id = np.array(slots.slam_id)
    slam_id[2] = 101
    opp_id = np.array(slots.opp_id)
    opp_id[np.array(opp_id) == 100] = -1  # consumed by msckf selection
    opp_id[np.array(opp_id) == 101] = -1  # promoted
    opp_id[np.array(opp_id) == 103] = -1  # died
    slots2 = dataclasses.replace(
        slots, slam_id=jnp.asarray(slam_id), opp_id=jnp.asarray(opp_id)
    )

    store2, work = ms.update_and_harvest(store, slots2, frame, SDIMS.max_peers)

    # msckf row 0 harvested
    assert bool(work.msckf_matched[0, 0])
    row = int(work.msckf_rows[0, 0])
    assert int(store.own_id[row]) == 100
    # slam upgrade emitted for own 101 -> slot 2
    sl = np.array(work.slam_matched)
    assert sl.any()
    srow = int(np.argmax(sl))
    assert int(store.own_id[srow]) == 101
    assert int(work.slam_own_idx[srow]) == 2
    # consumed + dead rows freed; live opp match (102) kept
    kept = np.array(store2.own_id)
    assert 102 in kept
    assert 100 not in kept and 101 not in kept and 103 not in kept


@pytest.mark.slow
def test_two_agent_store_roundtrip(rng):
    """End-to-end: B records matches against A's payload while its tracks
    are opportunistic; as the tracks mature into MSCKF rows the stored
    matches are consumed by joint CI inside the visual update."""
    desc_table = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    va, sim = run_agent((0.0, 0.0, 0.0), 1e-3, desc_table=desc_table)
    vb, _ = run_agent((0.25, 0.0, 0.0), 0.5, desc_table=desc_table)

    store = ms.MatchStore.zero(
        DIMS, ms.StoreDims(n_payloads=2, n_matches=16, max_peers=1),
        n_collab_tracks=8, dtype=jnp.float64,
    )
    ccfg = CCFG._replace(ci_msckf_w=0.05, ci_slam_w=0.01, desc_abs_thr=40.0,
                         max_peers=1)

    # A broadcasts; B records (opp x collab matches persist in the store)
    pay_a = collab.extract_payload_desc(PARAMS, va.fs, va.slots, n_collab_tracks=8)
    vb.fs, store, _, _ = collab.receive_and_record_jit(
        PARAMS, ccfg, vb.fs, vb.slots, store, pay_a, 0
    )
    assert int(np.sum(np.array(store.own_id) >= 0)) > 0, "no matches recorded"

    # continue B with store-aware visual updates until matches consume
    sim_b = sim
    t0 = sim.cam_t[-1]
    n_collab_total = 0
    extra = make_more_frames(vb, sim_b, t0, desc_table, ccfg, store)
    vb, store, n_collab_total = extra
    assert n_collab_total > 0, "stored matches were never consumed"


def make_more_frames(vb, sim, t0, desc_table, ccfg, store):
    """Drive ~13 more frames of agent B via visual_update_with_store
    (the opp->MSCKF maturation cycle is ~7 frames; 13 guarantees one)."""
    from x_multi_agent_jax.utils.sim import make_circle_sim

    sim2 = make_circle_sim(
        duration=sim.cam_t[-1] + 1.3, imu_rate=100.0, cam_rate=10.0,
        n_landmarks=30, match_budget=TRACKS.n_matches, pixel_noise=5e-4,
        seed=1,
    )
    from x_multi_agent_jax.vio import pipeline

    n_total = 0
    mask_new = sim2.imu_t > t0 + 1e-9
    imu_idx = np.where(mask_new)[0]
    imu_i = imu_idx[0] if len(imu_idx) else len(sim2.imu_t)
    for f, t_cam in enumerate(sim2.cam_t):
        if t_cam <= t0 + 1e-9:
            continue
        while imu_i < len(sim2.imu_t) and sim2.imu_t[imu_i] <= t_cam + 1e-9:
            vb.process_imu(sim2.imu_t[imu_i], imu_i, sim2.imu_w[imu_i],
                           sim2.imu_a[imu_i])
            imu_i += 1
        ids = np.clip(sim2.match_id[f], 0, len(desc_table) - 1)
        matches = tm.Matches.of(
            track_id=jnp.asarray(sim2.match_id[f]),
            prev_pt=jnp.asarray(sim2.match_prev[f]),
            cur_pt=jnp.asarray(sim2.match_cur[f]),
            valid=jnp.asarray(sim2.match_valid[f]),
            desc=jnp.asarray(desc_table[ids]),
            desc_valid=jnp.asarray(sim2.match_valid[f]),
        )
        meas = pipeline.FrameMeasurement.from_matches(PARAMS.cfg, matches)
        vb.fs, (vb.slots, store, n_collab), applied = (
            collab.visual_update_with_store_jit(
                PARAMS, ccfg, vb.fs, vb.slots, store, t_cam, meas
            )
        )
        n_total += int(np.array(n_collab))
    return vb, store, n_total


def test_record_gt_three_type_classification(rng):
    """GT_DEBUG breadth (place_recognition.cpp:387-517): id-equality
    classification must emit the same three match types as the descriptor
    path — own-OPP x peer-collab -> PEER_COLLAB, own-OPP x peer-SLAM ->
    PEER_SLAM — and feed the SAME upgrade machinery deterministically."""
    import dataclasses

    slots, _ = _slots_with_opp(rng, n_opp_active=4)  # own ids 100..103
    collab_desc = rng.integers(0, 256, (4, 32)).astype(np.uint8)
    slam_desc = rng.integers(0, 256, (TRACKS.n_slam, 32)).astype(np.uint8)
    payload = _payload(rng, collab_desc, slam_desc)
    # peer ids: collab track 2 shares landmark id 100 with our opp 100;
    # peer SLAM feature 3 shares id 102; id 555 matches nothing of ours
    trk_id = np.full(4, -1, np.int32)
    trk_id[2] = 100
    trk_id[0] = 555
    slam_id = np.full(TRACKS.n_slam, -1, np.int32)
    slam_id[3] = 102
    payload = dataclasses.replace(
        payload, trk_id=jnp.asarray(trk_id), slam_id=jnp.asarray(slam_id)
    )

    store = ms.MatchStore.zero(DIMS, SDIMS, n_collab_tracks=4, dtype=jnp.float64)
    store = ms.record_gt(store, slots, payload, 7)

    own_ids = np.array(store.own_id)
    assert 100 in own_ids and 102 in own_ids
    assert int(np.sum(own_ids >= 0)) == 2  # nothing spurious
    r0 = int(np.argmax(own_ids == 100))
    r2 = int(np.argmax(own_ids == 102))
    assert int(store.peer_type[r0]) == ms.PEER_COLLAB
    assert int(store.peer_idx[r0]) == 2
    assert int(store.peer_type[r2]) == ms.PEER_SLAM
    assert int(store.peer_idx[r2]) == 3

    # dedup on re-record
    store2 = ms.record_gt(store, slots, payload, 7)
    assert int(np.sum(np.array(store2.own_id) >= 0)) == 2

    # the stored GT matches drive the SAME upgrade machinery: own 100
    # selected as MSCKF this frame -> joint-MSCKF work; own 102 promoted
    # to SLAM slot 1 -> SLAM-SLAM upgrade
    frame = _empty_frame()
    frame = dataclasses.replace(
        frame,
        msckf_id=frame.msckf_id.at[0].set(100),
        msckf_valid=frame.msckf_valid.at[0].set(True),
    )
    slam_id_own = np.array(slots.slam_id)
    slam_id_own[1] = 102
    opp_id = np.array(slots.opp_id)
    opp_id[opp_id == 100] = -1
    opp_id[opp_id == 102] = -1
    slots2 = dataclasses.replace(
        slots, slam_id=jnp.asarray(slam_id_own), opp_id=jnp.asarray(opp_id)
    )
    _, work = ms.update_and_harvest(store, slots2, frame, SDIMS.max_peers)
    assert bool(work.msckf_matched[0, 0])
    assert int(store.own_id[int(work.msckf_rows[0, 0])]) == 100
    sl = np.array(work.slam_matched)
    assert sl.any()
    assert int(store.own_id[int(np.argmax(sl))]) == 102
    assert int(work.slam_own_idx[int(np.argmax(sl))]) == 1
