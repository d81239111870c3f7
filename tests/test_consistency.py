"""Filter consistency: Monte-Carlo NEES on the synthetic sequence
(SURVEY §4: 'filter-level consistency tests on synthetic trajectories with
processMatches-style injection (NEES/NIS bounds)')."""
import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.utils.evaluation import ate_rmse, nees
from x_multi_agent_jax.utils.sim import make_circle_sim
from x_multi_agent_jax.vio import track_manager as tm
from x_multi_agent_jax.vio import vio as vio_mod
from tests.test_vio_e2e import PARAMS, TRACKS


def run_once(seed, pixel_noise=1e-3):
    sim = make_circle_sim(
        duration=3.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
        match_budget=TRACKS.n_matches, pixel_noise=pixel_noise, seed=seed,
    )
    # sigma_img must reflect the injected noise for consistency
    params = PARAMS._replace(cfg=PARAMS.cfg._replace(sigma_img=pixel_noise))
    v = vio_mod.VIO(params)
    v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    imu_i = 0
    est, gt, covs = [], [], []
    for f, t_cam in enumerate(sim.cam_t):
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
            imu_i += 1
        matches = tm.Matches.of(
            track_id=jnp.asarray(sim.match_id[f]),
            prev_pt=jnp.asarray(sim.match_prev[f]),
            cur_pt=jnp.asarray(sim.match_cur[f]),
            valid=jnp.asarray(sim.match_valid[f]),
        )
        v.process_matches_measurement(t_cam, f, matches)
        core = v.anchor_state()
        est.append(np.array(core.p))
        gt.append(sim.cam_p[f])
        covs.append(np.array(v.fs.cov[:3, :3]))
    return np.array(est), np.array(gt), np.array(covs)


@pytest.mark.slow
def test_nees_consistency_monte_carlo():
    """Average position NEES over several runs stays within loose chi2
    bounds (a badly inconsistent filter is orders of magnitude off)."""
    all_nees = []
    ates = []
    for seed in range(3):
        est, gt, covs = run_once(seed)
        n = nees(est[5:], gt[5:], covs[5:])  # skip warmup
        all_nees.append(n)
        ates.append(ate_rmse(est, gt))
    mean_nees = float(np.mean(np.concatenate(all_nees)))
    # dim 3: consistent filter ~3. Allow generous band — the gauge
    # ambiguity and linearization push it up on long runs.
    assert 0.2 < mean_nees < 30.0, mean_nees
    assert max(ates) < 0.1, ates
