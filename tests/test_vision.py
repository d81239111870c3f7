import numpy as np
import jax
import jax.numpy as jnp

from x_multi_agent_jax.vision import camera as cam_mod
from x_multi_agent_jax.vision import fast, lk, tracker
from x_multi_agent_jax.vision.image import build_pyramid, bilinear_sample
from x_multi_agent_jax.ops.ransac import fundamental_ransac, sampson_dist


def synth_image(rng, h=96, w=128, n_blobs=30):
    """Smooth random blob image with good corners."""
    img = np.zeros((h, w))
    ys = rng.integers(10, h - 10, n_blobs)
    xs = rng.integers(10, w - 10, n_blobs)
    amps = rng.uniform(50, 200, n_blobs)
    yy, xx = np.mgrid[0:h, 0:w]
    for y, x, a in zip(ys, xs, amps):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 8.0)
    return img.astype(np.float64)


def naive_fast_score(img, t):
    """Reference implementation of the FAST-9 score for the oracle."""
    h, w = img.shape
    score = np.zeros((h, w))
    circle = fast.CIRCLE
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            d = np.array([img[y + dy, x + dx] - img[y, x] for (dy, dx) in circle])
            best = 0.0
            for sgn in (1, -1):
                v = sgn * d
                for i in range(16):
                    m = min(v[(i + j) % 16] for j in range(9))
                    best = max(best, m)
            if best > t:
                score[y, x] = best
    return score


def test_fast_score_matches_naive(rng):
    img = synth_image(rng, 32, 40, n_blobs=6)
    t = 10.0
    got = np.array(fast.fast_score(jnp.asarray(img), t))
    want = naive_fast_score(img, t)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_fast_detect_finds_blob_corners(rng):
    img = synth_image(rng)
    xy, score, valid = fast.detect(jnp.asarray(img), 10.0, 4, 4, 10)
    assert int(valid.sum()) > 10


def test_bilinear_sample_exact_on_grid(rng):
    img = rng.normal(size=(16, 16))
    pts = np.array([[3.0, 4.0], [7.0, 2.0]])
    got = np.array(bilinear_sample(jnp.asarray(img), jnp.asarray(pts)))
    np.testing.assert_allclose(got, [img[4, 3], img[2, 7]], atol=1e-12)


def test_lk_recovers_translation(rng):
    """Shift an image by a known subpixel amount; LK must recover it."""
    img = synth_image(rng)
    dx, dy = 3.4, -2.2
    yy, xx = np.mgrid[0 : img.shape[0], 0 : img.shape[1]].astype(float)
    img2 = np.array(
        bilinear_sample(
            jnp.asarray(img), jnp.stack([jnp.asarray(xx - dx), jnp.asarray(yy - dy)], -1)
        )
    )
    xy, score, valid = fast.detect(jnp.asarray(img), 10.0, 2, 2, 10)
    # keep detections away from borders
    keep = valid & (xy[:, 0] > 20) & (xy[:, 0] < 108) & (xy[:, 1] > 20) & (xy[:, 1] < 76)

    pyr1 = build_pyramid(jnp.asarray(img), 2)
    pyr2 = build_pyramid(jnp.asarray(img2), 2)
    pts2, ok = lk.track(pyr1, pyr2, xy, keep, half_win=7)
    ok = np.array(ok & keep)
    assert ok.sum() >= 5
    flow = np.array(pts2) - np.array(xy)
    err = flow[ok] - np.array([dx, dy])
    assert np.median(np.abs(err)) < 0.05, np.median(np.abs(err), axis=0)


def test_fundamental_ransac_rejects_outliers(rng):
    """Planar-ish scene with translating camera; inject gross outliers."""
    n = 60
    pts3d = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(4, 8, n)], 1
    )
    p1 = pts3d[:, :2] / pts3d[:, 2:3]
    t = np.array([0.3, 0.1, 0.0])
    rel = pts3d - t
    p2 = rel[:, :2] / rel[:, 2:3]
    # pixel-ish scale
    p1 = p1 * 300 + 300
    p2 = p2 * 300 + 300
    bad = np.zeros(n, bool)
    bad[:10] = True
    # displace outliers perpendicular to the (x-ish) epipolar direction —
    # motion along the epipolar line is legitimately undetectable by F
    perp = np.array([-0.1, 0.3]) / np.linalg.norm([0.3, 0.1])
    p2[bad] += np.outer(rng.uniform(15, 40, 10) * rng.choice([-1, 1], 10), perp)
    mask = np.ones(n, bool)

    inl, f = fundamental_ransac(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
        jax.random.PRNGKey(0), threshold=1.0,
    )
    inl = np.array(inl)
    assert inl[~bad].sum() >= 45  # most inliers kept
    assert inl[bad].sum() <= 1  # outliers rejected


def test_camera_undistort_roundtrip():
    cam = cam_mod.Camera.from_fractional(0.5, 0.6, 0.5, 0.5, 0.9, 640, 480)
    pts = jnp.asarray([[100.0, 100.0], [320.0, 240.0], [500.0, 400.0]])
    und = cam_mod.undistort(cam, pts)
    # FOV undistortion must be identity at the principal point
    np.testing.assert_allclose(np.array(und)[1], [320.0, 240.0], atol=1e-6)
    # and expand radially elsewhere (s>0 -> tan stretches)
    d0 = np.linalg.norm(np.array(pts)[0] - [320, 240])
    d1 = np.linalg.norm(np.array(und)[0] - [320, 240])
    assert d1 > d0


def test_tracker_end_to_end_translation(rng):
    """Detect on frame 0, track through translating frames; match ids are
    stable and flows consistent."""
    params = tracker.TrackerParams(
        budget=64, n_feat_min=30, n_tiles_h=2, n_tiles_w=2,
        max_feat_per_tile=20, block_half_length=8, margin=12, win_half=7,
        lk_max_level=2, fast_threshold=10.0,
    )
    cam = cam_mod.Camera.from_fractional(0.5, 0.5, 0.5, 0.5, 0.0, 128, 96)
    img0 = synth_image(rng)
    yy, xx = np.mgrid[0:96, 0:128].astype(float)

    def shifted(dx, dy):
        return np.array(
            bilinear_sample(
                jnp.asarray(img0),
                jnp.stack([jnp.asarray(xx - dx), jnp.asarray(yy - dy)], -1),
            )
        )

    st = tracker.TrackerState.zero(params, 96, 128, jnp.float64)
    st, m0 = tracker.track_frame(params, cam, st, jnp.asarray(img0))
    assert int(m0.valid.sum()) == 0  # first frame: no matches yet
    assert int((st.ids >= 0).sum()) >= 20  # but features detected

    st, m1 = tracker.track_frame(params, cam, st, jnp.asarray(shifted(2.0, 1.0)))
    n1 = int(m1.valid.sum())
    assert n1 >= 15
    # flow in normalized coords ~ (2 px / fx, 1 px / fy)
    flow = (np.array(m1.cur_pt) - np.array(m1.prev_pt))[np.array(m1.valid)]
    np.testing.assert_allclose(
        np.median(flow, axis=0), [2.0 / cam.fx, 1.0 / cam.fy], atol=0.15 / cam.fx
    )

    st, m2 = tracker.track_frame(params, cam, st, jnp.asarray(shifted(4.0, 2.0)))
    # ids persist between frames
    ids1 = set(np.array(m1.track_id)[np.array(m1.valid)].tolist())
    ids2 = set(np.array(m2.track_id)[np.array(m2.valid)].tolist())
    assert len(ids1 & ids2) >= 10


def test_per_level_fast_detection_catches_coarse_corners():
    """Reference detects FAST on every pyramid level (tracker.cpp:420-449):
    large smooth structures have gradients too shallow for base-level FAST
    but become sharp corners after pyrDown. pyramid_depth=1 (base only)
    must miss them; pyramid_depth=2 must find them and tag the level."""
    from scipy.ndimage import gaussian_filter

    img = np.zeros((128, 128), np.float64)
    img[40:90, 40:90] = 255.0
    img = gaussian_filter(img, 6.0)  # edges spread over ~12 px

    cam = cam_mod.Camera.from_fractional(0.5, 0.5, 0.5, 0.5, 0.0, 128, 128)

    def detect(depth):
        params = tracker.TrackerParams(
            budget=64, n_feat_min=30, n_tiles_h=4, n_tiles_w=4,
            max_feat_per_tile=10, block_half_length=8, margin=8,
            fast_threshold=9.0, pyramid_depth=depth, lk_max_level=2,
        )
        st = tracker.TrackerState.zero(params, 128, 128, jnp.float64)
        st, _ = tracker.track_frame(params, cam, st, jnp.asarray(img))
        return st

    st1 = detect(1)
    assert int((st1.ids >= 0).sum()) == 0  # base-level FAST sees nothing

    st2 = detect(2)
    live = np.array(st2.ids) >= 0
    assert live.sum() > 0
    assert np.all(np.array(st2.levels)[live] == 1)  # found at level 1
    # detected coords are in BASE-level pixels (scaled by 2^level), i.e.
    # around the blurred square corners
    pts = np.array(st2.pts)[live]
    assert pts[:, 0].min() > 20 and pts[:, 0].max() < 110


def test_match_carries_detection_level(rng):
    """Matches report the pyramid level features were detected at."""
    from scipy.ndimage import gaussian_filter

    img0 = np.zeros((128, 128), np.float64)
    img0[40:90, 40:90] = 255.0
    img0 = gaussian_filter(img0, 6.0)
    img0 = img0 + synth_image(rng, h=128, w=128) * 0.2

    params = tracker.TrackerParams(
        budget=64, n_feat_min=60, n_tiles_h=4, n_tiles_w=4,
        max_feat_per_tile=10, block_half_length=6, margin=8,
        fast_threshold=9.0, pyramid_depth=2, lk_max_level=2, win_half=7,
    )
    cam = cam_mod.Camera.from_fractional(0.5, 0.5, 0.5, 0.5, 0.0, 128, 128)
    st = tracker.TrackerState.zero(params, 128, 128, jnp.float64)
    st, _ = tracker.track_frame(params, cam, st, jnp.asarray(img0))
    levels0 = np.array(st.levels)[np.array(st.ids) >= 0]
    assert set(np.unique(levels0)) <= {0, 1}

    yy, xx = np.mgrid[0:128, 0:128].astype(float)
    img1 = np.array(
        bilinear_sample(
            jnp.asarray(img0),
            jnp.stack([jnp.asarray(xx - 1.5), jnp.asarray(yy - 0.5)], -1),
        )
    )
    st, m1 = tracker.track_frame(params, cam, st, jnp.asarray(img1))
    lv = np.array(m1.level)[np.array(m1.valid)]
    assert lv.size > 0 and set(np.unique(lv)) <= {0, 1}
