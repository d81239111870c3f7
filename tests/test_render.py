"""Observability: FrameDebug export + debug-image rendering
(reference GUI accessors ``vio.cpp:328-341`` and the debug plots of
``tracker.cpp:367-388`` / ``track_manager.cpp:638-731``)."""
import numpy as np
import jax.numpy as jnp

from x_multi_agent_jax.utils import render
from x_multi_agent_jax.vio import pipeline, vio as vio_mod
from x_multi_agent_jax.vio import track_manager as tm
from x_multi_agent_jax.utils.sim import make_circle_sim

from test_vio_e2e import PARAMS, TRACKS


def test_raster_primitives():
    img = np.zeros((40, 60), np.uint8)
    canvas = render.to_rgb(img)
    assert canvas.shape == (40, 60, 3) and canvas.dtype == np.uint8

    render.draw_line(canvas, (5, 5), (30, 20), (255, 0, 0))
    assert tuple(canvas[5, 5]) == (255, 0, 0)
    assert tuple(canvas[20, 30]) == (255, 0, 0)

    render.draw_circle(canvas, (45, 10), 4, (0, 255, 0))
    assert tuple(canvas[10, 49]) == (0, 255, 0)  # on the ring
    assert tuple(canvas[10, 45]) == (0, 0, 0)  # center not filled

    render.draw_circle(canvas, (45, 30), 3, (0, 0, 255), filled=True)
    assert tuple(canvas[30, 45]) == (0, 0, 255)

    before = canvas.sum()
    render.draw_text(canvas, (2, 28), "SLAM:12", (255, 255, 0))
    assert canvas.sum() > before

    # out-of-bounds drawing must not raise
    render.draw_line(canvas, (-10, -10), (100, 100), (1, 2, 3))
    render.draw_circle(canvas, (-5, 70), 4, (1, 2, 3))


def test_draw_matches_and_cross_agent():
    img = np.full((30, 30), 0.2)
    prev = np.array([[5.0, 5.0], [20.0, 10.0]])
    cur = np.array([[8.0, 7.0], [22.0, 12.0]])
    canvas = render.draw_matches(img, prev, cur, [True, False])
    assert (canvas == np.array(render.MATCH_COLOR)).all(-1).any()

    both = render.draw_cross_agent_matches(
        img, img, prev, cur, [True, True]
    )
    assert both.shape == (30, 60, 3)
    assert (both == np.array(render.MATCH_COLOR)).all(-1).any()


def _run_debug_frames(n_frames=25):
    sim = make_circle_sim(
        duration=n_frames / 10.0,
        imu_rate=100.0,
        cam_rate=10.0,
        n_landmarks=30,
        match_budget=TRACKS.n_matches,
        pixel_noise=5e-4,
        seed=3,
    )
    v = vio_mod.VIO(PARAMS, debug=True)
    v.init_at_time(0.0, v=np.array([1.5 * 1.2, 0.0, 0.0]))
    imu_i = 0
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
    return v, sim


def test_frame_debug_and_accessors():
    v, sim = _run_debug_frames()
    d = v.last_debug
    assert d is not None

    # SLAM telemetry consistent with the filter state
    n_valid = int(v.fs.vision.n_valid_features)
    assert int(np.asarray(d.slam_cart_valid, bool).sum()) == n_valid
    cart = v.get_slam_features_cartesian()
    assert cart.shape == (n_valid, 3)
    # landmarks live near the simulated ring (generous sanity bound)
    if n_valid:
        assert np.all(np.linalg.norm(cart, axis=1) < 50.0)

    inl, outl = v.get_msckf_tracks()
    assert inl.shape[1] == 2 and outl.shape[1] == 2

    # the debug-run filter matches the plain run bit-for-bit
    v2, _ = _run_plain_frames()
    np.testing.assert_array_equal(np.asarray(v.fs.cov), np.asarray(v2.fs.cov))

    # rendering produces class colors on the canvas
    img = np.zeros((480, 640), np.uint8)
    from x_multi_agent_jax.vision.camera import Camera

    cam = Camera.from_fractional(0.8, 0.8 * 640 / 480, 0.5, 0.5, 0.0, 640, 480)
    canvas = v.render_debug_image(img, cam)
    assert (canvas == np.array(render.SLAM_COLOR)).all(-1).any()


def _run_plain_frames(n_frames=25):
    sim = make_circle_sim(
        duration=n_frames / 10.0,
        imu_rate=100.0,
        cam_rate=10.0,
        n_landmarks=30,
        match_budget=TRACKS.n_matches,
        pixel_noise=5e-4,
        seed=3,
    )
    v = vio_mod.VIO(PARAMS, debug=False)
    v.init_at_time(0.0, v=np.array([1.5 * 1.2, 0.0, 0.0]))
    imu_i = 0
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
    return v, sim
