"""Per-tile SLAM-feature spreading/eviction (reference
``track_manager.cpp:310-395``) vs a Python oracle of the reference loop."""
import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.vio import track_manager as tm


def oracle_spread(n_bins, slam_tile, slam_alive, cand_tile, cand_valid, free):
    """Direct transliteration of the reference control flow (youngest =
    highest slot/candidate index; accepted-this-frame preferred for
    eviction, mirroring bin_track_idx[..].back() >= slam_trks_.size())."""
    counts = np.zeros(n_bins, int)
    for i, t in enumerate(slam_tile):
        if slam_alive[i] and 0 <= t < n_bins:
            counts[t] += 1
    accept = np.zeros(len(cand_tile), bool)
    evict = np.zeros(len(slam_tile), bool)
    for t in range(len(cand_tile)):
        if not cand_valid[t] or cand_tile[t] < 0:
            continue
        bt = cand_tile[t]
        maxbin = int(np.argmax(counts))
        if free > 0:
            accept[t] = True
            counts[bt] += 1
            free -= 1
        elif counts[maxbin] > counts[bt] + 1:
            # evict youngest in maxbin: accepted candidate first, else
            # newest existing slam track
            new_js = [j for j in range(len(cand_tile))
                      if accept[j] and cand_tile[j] == maxbin]
            if new_js:
                accept[new_js[-1]] = False
            else:
                old_js = [j for j in range(len(slam_tile))
                          if slam_alive[j] and not evict[j]
                          and slam_tile[j] == maxbin]
                if not old_js:
                    continue
                evict[old_js[-1]] = True
            counts[maxbin] -= 1
            accept[t] = True
            counts[bt] += 1
    return accept, evict


@pytest.mark.parametrize("seed", range(6))
def test_spread_scan_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n_bins = 4
    n_slam, n_cand = 10, 8
    slam_tile = rng.integers(-1, n_bins, n_slam).astype(np.int32)
    slam_alive = rng.random(n_slam) < 0.8
    cand_tile = rng.integers(-1, n_bins, n_cand).astype(np.int32)
    cand_valid = rng.random(n_cand) < 0.8
    free = int(rng.integers(0, 3))

    acc_o, ev_o = oracle_spread(
        n_bins, slam_tile, slam_alive, cand_tile, cand_valid, free
    )
    acc_j, ev_j = tm._spread_scan(
        n_bins,
        jnp.asarray(slam_tile),
        jnp.asarray(slam_alive),
        jnp.asarray(cand_tile),
        jnp.asarray(cand_valid),
        free,
    )
    np.testing.assert_array_equal(np.array(acc_j), acc_o)
    np.testing.assert_array_equal(np.array(ev_j), ev_o)


def test_spreading_evicts_crowded_bin():
    """All existing SLAM features in bin 0; a long candidate in empty bin 3
    must evict the youngest bin-0 feature and take its slot."""
    n_bins = 4
    slam_tile = jnp.asarray([0, 0, 0, 0], jnp.int32)
    slam_alive = jnp.ones(4, bool)
    cand_tile = jnp.asarray([3], jnp.int32)
    cand_valid = jnp.ones(1, bool)
    accept, evict = tm._spread_scan(
        n_bins, slam_tile, slam_alive, cand_tile, cand_valid, 0
    )
    assert bool(accept[0])
    np.testing.assert_array_equal(np.array(evict), [False, False, False, True])


def test_manage_tracks_spreading_end_to_end(rng):
    """With tiling on, a mature track in an under-represented tile evicts a
    SLAM feature from the fullest tile (emitted via lost_slam)."""
    import dataclasses

    dims = tm.TrackDims(
        n_slam=4, n_poses=4, n_opp=8, n_matches=8, n_msckf=4, n_short=4,
        n_new_slam=4, n_tiles_h=2, n_tiles_w=2,
    )
    slots = tm.TrackSlots.zero(dims, jnp.float64)
    # 4 active SLAM features, all in tile 0 -> SLAM budget full
    slots = dataclasses.replace(
        slots,
        slam_id=jnp.asarray([0, 1, 2, 3], jnp.int32),
        slam_tile=jnp.zeros(4, jnp.int32),
        slam_mask=jnp.ones((4, 4), bool),
    )
    # one mature opp track (id 10) with obs in tile 3
    slots = dataclasses.replace(
        slots,
        opp_id=slots.opp_id.at[0].set(10),
        opp_length=slots.opp_length.at[0].set(10),
        opp_tile=slots.opp_tile.at[0].set(3),
        opp_mask=slots.opp_mask.at[0, :].set(True),
        opp_obs=slots.opp_obs.at[0, :, 0].set(
            jnp.asarray([0.0, 0.1, 0.2, 0.3])
        ),
    )
    q_list = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0]), (4, 1))
    matches = tm.Matches.of(
        track_id=jnp.asarray([0, 1, 2, 3, 10, -1, -1, -1], jnp.int32),
        prev_pt=jnp.zeros((8, 2), jnp.float64),
        cur_pt=jnp.asarray(rng.normal(size=(8, 2)) * 0.1),
        valid=jnp.asarray([True] * 5 + [False] * 3),
        tile=jnp.asarray([0, 0, 0, 0, 3, -1, -1, -1], jnp.int32),
    )
    new_slots, frame, _ = tm.manage_tracks(
        dims, slots, matches, q_list, q_list[0], min_track_length=5,
        min_baseline_x=0.01, min_baseline_y=0.01,
    )
    # the candidate was accepted (appears in new_*) and one slam feature
    # from the crowded tile was evicted via lost_slam
    assert bool(frame.new_valid.any())
    assert 10 in np.array(frame.new_id)
    assert int(np.sum(np.array(frame.lost_slam))) == 1
    assert bool(frame.lost_slam[3])  # youngest = highest slot
