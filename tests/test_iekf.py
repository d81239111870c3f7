"""IEKF iteration loop (reference ``iekf_iter`` param, vio/types.h; update
loop ``updater.cpp:86-109``): iterations re-linearize Jacobians/residuals
against the corrected state with the it-0 TRIANGULATION frozen, using the
accumulated-correction residual term K(res + H corr_tot) - corr_tot
(``updater.cpp:117-141``).

Two bugs this file locked in when first exercised (round 3):
  * feature init received the TOTAL accumulated correction instead of the
    post-last-build increment -> every landmark initialized with a
    double-counted offset (iekf_iter=3 drifted 5x worse than 1);
  * per-iteration re-triangulation let the feature point absorb each
    correction, breaking the residual algebra.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.ekf import buffer as rb, ekf as ekf_mod
from x_multi_agent_jax.utils.sim import make_circle_sim
from x_multi_agent_jax.vio import pipeline
from x_multi_agent_jax.vio import track_manager as tm
from x_multi_agent_jax.vio import vio as vio_mod
from tests.test_vio_e2e import PARAMS, TRACKS


def _params(iekf_iter):
    return PARAMS._replace(
        cfg=PARAMS.cfg._replace(sigma_img=5e-4, iekf_iter=iekf_iter),
        sigma_dtheta_deg=(10.0, 10.0, 10.0),
    )


def _matches(sim, f):
    return tm.Matches.of(
        track_id=jnp.asarray(sim.match_id[f]),
        prev_pt=jnp.asarray(sim.match_prev[f]),
        cur_pt=jnp.asarray(sim.match_cur[f]),
        valid=jnp.asarray(sim.match_valid[f]),
    )


def _drive_prefix(n_frames=8, seed=3):
    """Warm a filter (iekf=1) over the sim prefix."""
    sim = make_circle_sim(
        duration=2.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
        match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=seed,
    )
    v = vio_mod.VIO(_params(1))
    v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))
    imu_i = 0
    for f in range(n_frames):
        t_cam = sim.cam_t[f]
        while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
            v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
            imu_i += 1
        v.process_matches_measurement(t_cam, f, _matches(sim, f))
    return v, sim, imu_i, n_frames


def _perturb_attitude(fs, yaw_deg):
    """Inject a yaw error into the newest (head) core state — the strongly
    nonlinear direction of the projection model — plus matching yaw
    covariance (or the chi2 gates would, correctly, reject everything)."""
    th = np.deg2rad(yaw_deg)
    dq = jnp.asarray([0.0, 0.0, np.sin(th / 2), np.cos(th / 2)], fs.cov.dtype)
    core = ekf_mod.tail_core(fs)
    x1, y1, z1, w1 = dq
    x2, y2, z2, w2 = core.q
    q_new = jnp.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    core2 = dataclasses.replace(core, q=q_new)
    buf = rb.set_slot(fs.buffer, fs.head, core2)
    var = np.deg2rad(1.5 * abs(yaw_deg)) ** 2
    cov = fs.cov.at[8, 8].add(var)
    return dataclasses.replace(fs, buffer=buf, cov=cov)


def _one_frame_update(iekf_iter, yaw_err_deg, prefix, res_log=None):
    v0, sim, imu_i, f = prefix
    v = vio_mod.VIO(_params(iekf_iter))
    v.fs, v.slots = v0.fs, v0.slots
    t_cam = sim.cam_t[f]
    imu_j = imu_i
    while imu_j < len(sim.imu_t) and sim.imu_t[imu_j] <= t_cam + 1e-9:
        v.process_imu(sim.imu_t[imu_j], imu_j, sim.imu_w[imu_j], sim.imu_a[imu_j])
        imu_j += 1
    if yaw_err_deg:
        v.fs = _perturb_attitude(v.fs, yaw_err_deg)
    orig = pipeline._apply_rows
    if res_log is not None:
        import jax

        def spy(cov, jac, res, std, corr_tot, cov_update=True):
            # runs under jit: capture the runtime value via callback
            jax.debug.callback(
                lambda v: res_log.append(float(v)), jnp.linalg.norm(res / std)
            )
            return orig(cov, jac, res, std, corr_tot, cov_update)

        pipeline._apply_rows = spy
    try:
        v.process_matches_measurement(t_cam, f, _matches(sim, f))
    finally:
        pipeline._apply_rows = orig
    assert bool(jnp.isfinite(v.fs.cov).all())
    return np.linalg.norm(np.asarray(v.tail_state().p) - sim.cam_p[f])


@pytest.mark.slow
def test_iekf_iterations_reduce_residual():
    """Single-frame oracle: with a 10-degree injected yaw error, the first
    linearization's residual is huge; each IEKF iteration re-evaluates the
    stacked residual at the corrected state, so the LAST iteration's
    input residual must be far below the first's (the defining Gauss-
    Newton property). The state stays bounded: on a single gauge-
    ambiguous VIO window the iterated MAP estimate may sit slightly
    further in position while fitting the measurements much better, so
    position error alone is NOT the oracle here."""
    prefix = _drive_prefix()
    log3 = []
    e3 = _one_frame_update(3, 10.0, prefix, res_log=log3)
    # log3 entries: [short-msckf pre-update, iekf it1, it2, it3]
    iters = log3[-3:]
    assert iters[1] < 0.15 * iters[0], iters
    assert iters[2] < iters[1], iters
    e1 = _one_frame_update(1, 10.0, prefix)
    assert e3 < 2.0 * e1 + 1e-3, (e1, e3)  # bounded, no divergence


@pytest.mark.slow
def test_iekf_noop_in_linear_regime():
    """With no injected error the update is near-linear: extra iterations
    barely move the single-frame result (the pre-fix implementation
    drifted centimetres here from the feature-init double-count)."""
    prefix = _drive_prefix()
    e1 = _one_frame_update(1, 0.0, prefix)
    e3 = _one_frame_update(3, 0.0, prefix)
    assert abs(e1 - e3) < 5e-3, (e1, e3)
