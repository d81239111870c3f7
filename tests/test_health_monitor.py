"""Divergence detection + automatic re-initialization (SURVEY §5.3).

The reference exposes re-init (``VIO::initAtTime``, vio.cpp:54-111) but
relies on an operator to invoke it; the round-3 replay showed agents
silently riding a diverged state for tens of seconds. The health monitor
(vio.py:enable_health_monitor) gates starved frames and re-inits from the
current estimate after a run of unhealthy frames.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.ekf.state import StateDims
from x_multi_agent_jax.vio import pipeline, vio as vio_mod
from x_multi_agent_jax.vio import track_manager as tm
from x_multi_agent_jax.utils.sim import make_circle_sim

DIMS = StateDims(n_poses=8, n_features=8, buffer_size=64)
TRACKS = tm.TrackDims(
    n_slam=8, n_poses=8, n_opp=40, n_matches=60, n_msckf=8, n_short=6,
    n_new_slam=8,
)
CFG = pipeline.VioConfig(
    dims=DIMS, tracks=TRACKS, sigma_img=2e-3, min_track_length=5,
    msckf_baseline_x_n=0.01, msckf_baseline_y_n=0.01, obs_constrained=False,
)
PARAMS = vio_mod.VioParams(
    cfg=CFG, dtype="float64", max_update_lag=32,
    sigma_dv=(0.05,) * 3, sigma_dtheta_deg=(1.0,) * 3,
    sigma_dbw_deg=(1.0,) * 3, sigma_dba=(0.05,) * 3,
)


def run_with_outage(outage=(2.0, 3.0), max_bad_frames=5):
    """Visual outage: every match is invalidated inside ``outage``; the
    tracker-equivalent signal a real front-end produces when the scene is
    washed out."""
    sim = make_circle_sim(
        duration=6.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
        match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=3,
    )
    v = vio_mod.VIO(PARAMS)
    v.init_at_time(0.0, v=np.array([1.5 * 1.2, 0.0, 0.0]))
    v.enable_health_monitor(
        min_matches=8, max_bad_frames=max_bad_frames, cov_pos_max=None
    )
    imu_i = 0
    gated = 0
    est_p, true_p = [], []
    for f, t_cam in enumerate(sim.cam_t):
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            v.process_imu(
                sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i]
            )
            imu_i += 1
        valid = sim.match_valid[f]
        if outage[0] <= t_cam < outage[1]:
            valid = np.zeros_like(valid)
        matches = tm.Matches.of(
            track_id=jnp.asarray(sim.match_id[f]),
            prev_pt=jnp.asarray(sim.match_prev[f]),
            cur_pt=jnp.asarray(sim.match_cur[f]),
            valid=jnp.asarray(valid),
        )
        applied = v.process_matches_measurement(t_cam, f, matches)
        if not applied:
            gated += 1
        est_p.append(np.asarray(v.tail_state().p))
        true_p.append(sim.cam_p[f])
    return v, np.asarray(est_p), np.asarray(true_p), gated


@pytest.mark.slow
def test_outage_triggers_reinit_and_recovers():
    v, est_p, true_p, gated = run_with_outage()
    # every outage frame was withheld from the filter
    assert gated >= 10
    # the run of unhealthy frames triggered automatic re-init
    assert v.n_reinits >= 1
    # the filter kept running and stays finite after recovery
    assert np.isfinite(est_p).all()
    # after matches return, incremental drift over the final 2 s is small
    # (global position is unobservable, so compare displacement deltas)
    d_est = est_p[-1] - est_p[-20]
    d_true = true_p[-1] - true_p[-20]
    assert np.linalg.norm(d_est - d_true) < 0.25, (
        f"post-recovery drift {np.linalg.norm(d_est - d_true):.3f} m"
    )
    # covariance stays symmetric + PSD-ish
    cov = np.asarray(v.fs.cov)
    np.testing.assert_allclose(cov, cov.T, atol=1e-9)
    assert np.all(np.linalg.eigvalsh(cov) > -1e-8)


def test_reinit_carries_core_covariance():
    """Re-init must not make the filter more confident: the core block is
    carried over, the vision blocks reset."""
    v = vio_mod.VIO(PARAMS)
    v.init_at_time(0.0, v=np.zeros(3))
    v.enable_health_monitor(min_matches=8, max_bad_frames=1)
    # feed a little IMU so there is a tail state
    for i in range(10):
        v.process_imu(0.01 * (i + 1), i, np.zeros(3), np.array([0, 0, 9.81]))
    cov_before = np.asarray(v.fs.cov[:15, :15])
    p_before = np.asarray(v.tail_state().p)
    v._reinit_from_current()
    assert v.n_reinits == 1
    np.testing.assert_allclose(
        np.asarray(v.fs.cov[:15, :15]), cov_before, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(v.tail_state().p), p_before, atol=1e-12
    )
    # vision blocks are reset to zero
    assert np.all(np.asarray(v.fs.cov[15:, 15:]) == 0.0)
