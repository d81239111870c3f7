"""Closed REQUEST_COMM loop through the VIO facade (reference MULTI_UAV +
REQUEST_COMM build): keyframes are selected by the postUpdate heuristic
(vio_updater.cpp:451-484), stored in the ring DB, answered to VLAD queries
(vio.cpp:455-495), and fused by the requester — measuring shipped bytes vs
full-broadcast mode (the up-to-89% reduction claim, README.md:98-99)."""
import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.parallel import collab
from x_multi_agent_jax.place_recognition.vocabulary import train_kmajority
from x_multi_agent_jax.utils.sim import make_circle_sim
from x_multi_agent_jax.vio import track_manager as tm, vio as vio_mod

from tests.test_collab import PARAMS, TRACKS


def rand_desc(rng, n):
    return rng.integers(0, 256, (n, 32)).astype(np.uint8)


def _mk_agent(rng_seed, offset, sigma_dp, words, ccfg, uav_id):
    params = PARAMS._replace(sigma_dp=(sigma_dp,) * 3)
    v = vio_mod.VIO(params)
    v.init_at_time(0.0, p=np.asarray(offset), v=np.array([1.8, 0.0, 0.0]))
    v.enable_collab(words, uav_id=uav_id, ccfg=ccfg)
    return v


@pytest.mark.slow
def test_request_comm_closed_loop(rng):
    duration = 5.0
    desc_table = rand_desc(rng, 40)
    words = jnp.asarray(train_kmajority(rand_desc(rng, 400), 16, 5).words)
    ccfg = collab.CollabConfig(
        sigma_landmark=0.02, ci_slam_w=0.5, match_budget=8,
        desc_ratio_thr=0.9, desc_abs_thr=40.0, pr_score_thr=0.2,
    )

    sims = [
        make_circle_sim(
            duration=duration, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
            match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=s,
        )
        for s in (1, 1)
    ]
    # agent 0: well-initialized; agent 1: offset + loose prior (the
    # degraded agent that benefits from collaboration)
    agents = [
        _mk_agent(0, (0.0, 0.0, 0.0), 1e-3, words, ccfg, uav_id=0),
        _mk_agent(1, (0.25, 0.0, 0.0), 0.5, words, ccfg, uav_id=1),
    ]

    payload_b = collab.payload_nbytes(agents[0].get_data_to_send())
    vlad_b = collab.vlad_nbytes(words)
    assert vlad_b < payload_b / 20  # the query must be cheap vs the payload

    bytes_rr = 0  # request-response policy
    bytes_full = 0  # full-broadcast mode baseline (vio.cpp:440-451)
    n_hits = 0
    n_fused = 0

    imu_is = [0, 0]
    n_frames = len(sims[0].cam_t)
    for f in range(n_frames):
        for a, (v, sim) in enumerate(zip(agents, sims)):
            t_cam = sim.cam_t[f]
            i = imu_is[a]
            while i < len(sim.imu_t) and sim.imu_t[i] <= t_cam + 1e-9:
                v.process_imu(sim.imu_t[i], i, sim.imu_w[i], sim.imu_a[i])
                i += 1
            imu_is[a] = i
            ids = sim.match_id[f]
            matches = tm.Matches.of(
                track_id=jnp.asarray(ids),
                prev_pt=jnp.asarray(sim.match_prev[f]),
                cur_pt=jnp.asarray(sim.match_cur[f]),
                valid=jnp.asarray(sim.match_valid[f]),
                desc=jnp.asarray(desc_table[np.clip(ids, 0, 39)]),
                desc_valid=jnp.asarray(sim.match_valid[f]),
            )
            v.process_matches_measurement(sim.cam_t[f], f, matches)

        # full-exchange baseline: the reference's broadcast mode ships the
        # SimpleState payload to every peer at EVERY visual update
        # (getDataToSend, vio.cpp:440-451) — the paper's 89% reduction is
        # measured against that (README.md:98-99)
        bytes_full += 2 * payload_b
        # exchange round every 3 frames (requester broadcasts VLAD; the
        # responder ships the heavy keyframe only on a hit)
        if f % 3 == 2:
            for req in range(2):
                res = 1 - req
                vlad = agents[req].get_descriptors()
                bytes_rr += vlad_b
                payload, found = agents[res].process_other_requests(req, vlad)
                if found:
                    bytes_rr += payload_b
                    n_hits += 1
                    n_fused += agents[req].process_other_measurements(
                        payload, uav_id=res
                    )

    # the selection heuristic must fire on its own (no manual DB writes)
    assert agents[0].n_keyframes_selected >= 1
    assert n_hits >= 1, "request-response must produce at least one hit"
    assert n_fused >= 1, "hits must CI-fuse matched landmarks"

    reduction = 1.0 - bytes_rr / bytes_full
    # served-once semantics: after a keyframe is shipped, later rounds cost
    # only the VLAD -> the saving must reach the reference's claimed
    # regime (README.md:98-99: up to 89%)
    assert reduction > 0.85, (reduction, bytes_rr, bytes_full, n_hits)

    # the degraded agent must end closer to truth than it started
    true_p = sims[1].cam_p[-1]
    err = np.linalg.norm(np.array(agents[1].tail_state().p) - true_p)
    assert err < 0.25, err
