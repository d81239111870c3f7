"""Full image-driven single-agent VIO (config 1 of BASELINE.json): FAST +
LK tracking -> match classification -> MSCKF/SLAM EKF, on rendered
synthetic imagery."""
import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.ekf.state import StateDims
from x_multi_agent_jax.vio import pipeline, vio as vio_mod
from x_multi_agent_jax.vio import track_manager as tm
from x_multi_agent_jax.vision import camera as cam_mod
from x_multi_agent_jax.vision import tracker as trk_mod

H, W = 96, 128
FX = FY = 110.0

DIMS = StateDims(n_poses=8, n_features=8, buffer_size=64)
TRACKS = tm.TrackDims(
    n_slam=8, n_poses=8, n_opp=40, n_matches=64, n_msckf=8, n_short=6, n_new_slam=8
)
CFG = pipeline.VioConfig(
    dims=DIMS, tracks=TRACKS, sigma_img=2.0 / FX, min_track_length=5,
    msckf_baseline_x_n=0.005, msckf_baseline_y_n=0.005, obs_constrained=False,
)
PARAMS = vio_mod.VioParams(
    cfg=CFG, dtype="float64", max_update_lag=32,
    sigma_dv=(0.05, 0.05, 0.05), sigma_dtheta_deg=(1.0, 1.0, 1.0),
    sigma_dbw_deg=(1.0, 1.0, 1.0), sigma_dba=(0.05, 0.05, 0.05),
)
TPARAMS = trk_mod.TrackerParams(
    budget=64, n_feat_min=25, n_tiles_h=2, n_tiles_w=2, max_feat_per_tile=16,
    block_half_length=6, margin=10, win_half=7, lk_max_level=2,
    fast_threshold=8.0, ransac_threshold_px=1.0,
)
CAM = cam_mod.Camera(FX, FY, W / 2, H / 2, 0.0, W, H)


def render(landmarks, amps, p_cam):
    """Splat landmarks as Gaussians at their projected positions."""
    rel = landmarks - p_cam
    uv = rel[:, :2] / rel[:, 2:3]
    px = uv[:, 0] * FX + W / 2
    py = uv[:, 1] * FY + H / 2
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W))
    for x, y, a in zip(px, py, amps):
        if -5 < x < W + 5 and -5 < y < H + 5:
            img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 6.0)
    return img


@pytest.mark.slow
def test_image_driven_vio_tracks_trajectory(rng):
    n_lm = 40
    landmarks = np.stack(
        [rng.uniform(-3.5, 3.5, n_lm), rng.uniform(-2.5, 2.5, n_lm),
         rng.uniform(5, 9, n_lm)], 1,
    )
    amps = rng.uniform(120, 220, n_lm)

    radius, omega = 0.8, 1.2
    duration, imu_rate, cam_rate = 3.0, 100.0, 10.0

    def pos(t):
        return np.array(
            [radius * np.sin(omega * t), radius * (1 - np.cos(omega * t)), 0.0]
        )

    def acc(t):
        return np.array(
            [-radius * omega**2 * np.sin(omega * t),
             radius * omega**2 * np.cos(omega * t), 0.0]
        )

    v = vio_mod.VIO(PARAMS)
    v.init_at_time(0.0, v=np.array([radius * omega, 0.0, 0.0]))
    v.setup_tracker(TPARAMS, CAM, H, W)

    n_imu = int(duration * imu_rate)
    imu_t = (np.arange(n_imu) + 1) / imu_rate
    cam_every = int(imu_rate / cam_rate)

    # frame 0 at t=0 seeds the tracker before IMU starts
    v.process_image_measurement(0.0, 0, render(landmarks, amps, pos(0.0)))

    errs = []
    for i, t in enumerate(imu_t):
        v.process_imu(t, i, np.zeros(3), acc(t) + [0, 0, 9.81])
        if (i + 1) % cam_every == 0:
            img = render(landmarks, amps, pos(t))
            v.process_image_measurement(t, i, img)
            tail = v.tail_state()
            errs.append(np.linalg.norm(np.array(tail.p) - pos(t)))

    errs = np.array(errs)
    rmse = np.sqrt(np.mean(errs**2))
    # image-driven: tracking noise is real (subpixel LK on rendered blobs),
    # so the tolerance is looser than the match-driven test
    assert rmse < 0.15, f"RMSE {rmse:.3f} m; tail {errs[-5:]}"
    assert int(v.fs.vision.n_valid_features) > 0


@pytest.mark.slow
def test_thermal_image_vio_with_photometric_calibration(rng):
    """Config 2: drifting affine gain distortion on the rendered images;
    the online photometric calibration must keep tracking stable."""
    n_lm = 40
    landmarks = np.stack(
        [rng.uniform(-3.5, 3.5, n_lm), rng.uniform(-2.5, 2.5, n_lm),
         rng.uniform(5, 9, n_lm)], 1,
    )
    amps = rng.uniform(120, 220, n_lm)
    radius, omega = 0.8, 1.2
    duration, imu_rate, cam_rate = 2.0, 100.0, 10.0

    def pos(t):
        return np.array(
            [radius * np.sin(omega * t), radius * (1 - np.cos(omega * t)), 0.0]
        )

    def acc(t):
        return np.array(
            [-radius * omega**2 * np.sin(omega * t),
             radius * omega**2 * np.cos(omega * t), 0.0]
        )

    v = vio_mod.VIO(PARAMS)
    v.init_at_time(0.0, v=np.array([radius * omega, 0.0, 0.0]))
    v.setup_tracker(TPARAMS, CAM, H, W)
    v.enable_photometric(n_obs=64)

    def thermal(img, k):
        # slowly drifting gain (a, b)
        a = 1.0 + 0.01 * k
        b = 0.002 * k
        return np.clip((img / 255.0) * (a - b) + b, 0, 1) * 255.0

    v.process_image_measurement(0.0, 0, thermal(render(landmarks, amps, pos(0.0)), 0))
    n_imu = int(duration * imu_rate)
    imu_t = (np.arange(n_imu) + 1) / imu_rate
    cam_every = int(imu_rate / cam_rate)
    errs = []
    k = 1
    for i, t in enumerate(imu_t):
        v.process_imu(t, i, np.zeros(3), acc(t) + [0, 0, 9.81])
        if (i + 1) % cam_every == 0:
            img = thermal(render(landmarks, amps, pos(t)), k)
            k += 1
            v.process_image_measurement(t, i, img)
            errs.append(np.linalg.norm(np.array(v.tail_state().p) - pos(t)))
    errs = np.array(errs)
    rmse = np.sqrt(np.mean(errs**2))
    assert rmse < 0.25, f"RMSE {rmse:.3f} m under thermal gain drift"


@pytest.mark.slow
def test_thermal_spatial_vignetting_recovered(rng):
    """Config 2 + spatial: a static spatially non-uniform gain field
    (corner vignette) on top of drifting global gains. Global-only
    correction cannot remove it (it violates brightness constancy as
    features sweep the field); the online spatial solver
    (irPhotoCalib.cpp:314-406,442-472 equivalent) must estimate a map
    correlated with the truth and improve tracking.

    Blob amplitudes stay below saturation: clipping at 1.0 systematically
    biases the residual rows (found the hard way — saturated corners make
    the estimated field anti-correlate with the truth)."""
    n_lm = 40
    landmarks = np.stack(
        [rng.uniform(-3.5, 3.5, n_lm), rng.uniform(-2.5, 2.5, n_lm),
         rng.uniform(5, 9, n_lm)], 1,
    )
    amps = rng.uniform(70, 140, n_lm)
    radius, omega = 0.8, 1.2
    duration, imu_rate, cam_rate = 3.0, 100.0, 10.0

    def pos(t):
        return np.array(
            [radius * np.sin(omega * t), radius * (1 - np.cos(omega * t)), 0.0]
        )

    def acc(t):
        return np.array(
            [-radius * omega**2 * np.sin(omega * t),
             radius * omega**2 * np.cos(omega * t), 0.0]
        )

    # static spatial offset field: strong corner vignette (normalized units)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    r2 = ((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2
    ps_true = 0.12 * r2  # up to +0.24 in the corners (~60/255)

    def thermal(img, k):
        a = 1.0 + 0.008 * k
        b = 0.002 * k
        return np.clip((img / 255.0) * (a - b) + b + ps_true, 0, 1) * 255.0

    def run(spatial):
        v = vio_mod.VIO(PARAMS)
        v.init_at_time(0.0, v=np.array([radius * omega, 0.0, 0.0]))
        v.setup_tracker(TPARAMS, CAM, H, W)
        v.enable_photometric(
            # 12 px cells: feature displacements between paired frames are
            # ~5-20 px, so coarser cells make most rows same-cell (no
            # spatial signal) and attenuate the recovered field by the
            # crossing-gap/cell-pitch ratio (measured: corr 0.39 at 24 px
            # cells vs 0.68 at 12 px on identical data)
            n_obs=64, spatial=spatial, cell_px=12, spatial_every=5,
        )
        v.process_image_measurement(
            0.0, 0, thermal(render(landmarks, amps, pos(0.0)), 0)
        )
        n_imu = int(duration * imu_rate)
        imu_t = (np.arange(n_imu) + 1) / imu_rate
        cam_every = int(imu_rate / cam_rate)
        errs = []
        k = 1
        for i, t in enumerate(imu_t):
            v.process_imu(t, i, np.zeros(3), acc(t) + [0, 0, 9.81])
            if (i + 1) % cam_every == 0:
                v.process_image_measurement(
                    t, i, thermal(render(landmarks, amps, pos(t)), k)
                )
                k += 1
                errs.append(np.linalg.norm(np.array(v.tail_state().p) - pos(t)))
        return v, np.sqrt(np.mean(np.square(errs)))

    v_sp, rmse_sp = run(True)
    assert v_sp._photo_ps is not None, "spatial solver never ran"
    est = np.asarray(v_sp._photo_ps, float)
    # the estimated map must correlate with the true field WHERE IT WAS
    # OBSERVED (both defined up to a constant -> compare centered).
    # Unobserved cells — the extreme corners, which FAST's margin and the
    # vignette's darkening keep feature-free — get the GPR prior (~0)
    # while the true field peaks exactly there, so a whole-image
    # correlation measures the feature distribution, not the estimator.
    sp = v_sp._photo_spatial
    ncx, ncy, div = sp["ncx"], sp["ncy"], sp["cell_px"]
    sids = np.concatenate([
        np.asarray(sp["sid_hist"])[np.asarray(sp["valid"])],
        np.asarray(sp["sid_cur"])[np.asarray(sp["valid"])],
    ])
    seen_cells = np.zeros(ncx * ncy, bool)
    seen_cells[np.unique(sids)] = True
    seen_px = np.repeat(
        np.repeat(seen_cells.reshape(ncy, ncx), div, 0), div, 1
    )[:H, :W]
    e = est[seen_px]
    t = ps_true[seen_px]
    e = e - e.mean()
    t = t - t.mean()
    corr = float(
        (e * t).sum() / max(np.linalg.norm(e) * np.linalg.norm(t), 1e-12)
    )
    # threshold note: the per-row SNR is intrinsically low — a row is the
    # intensity difference of one feature between two nearby cells, where
    # the true field differs by ~0.01 while subpixel-sampling noise on
    # sharp texture is of the same order (measured per-row correlation
    # with the true cell difference: ~0.2). The solved map is therefore
    # positively but noisily correlated; across fp32/fp64 runs of this
    # exact scenario the observed-cells correlation ranged 0.38-0.68.
    # 0.3 asserts genuine recovery (sign + shape) without flaking.
    assert corr > 0.3, f"spatial map corr {corr:.2f} (observed cells)"
    assert np.isfinite(rmse_sp) and rmse_sp < 0.25, f"RMSE {rmse_sp:.3f}"
