"""Photometric calibration (config 2): gain estimation, chaining, drift
anchoring, spatial solve + GPR, image correction."""
import numpy as np
import jax
import jax.numpy as jnp

from x_multi_agent_jax.photometric import calib


def test_gain_algebra_roundtrip(rng):
    a1, b1 = 1.1, 0.03
    a12, b12 = 0.95, -0.02
    a2, b2 = calib.chain_gains(a1, b1, a12, b12)
    a12r, b12r = calib.relative_gains(a1, b1, a2, b2)
    np.testing.assert_allclose([a12r, b12r], [a12, b12], atol=1e-12)


def test_gain_ransac_recovers_affine(rng):
    j = 60
    op = rng.uniform(0.1, 0.9, j)  # current-frame intensities
    a_true, b_true = 1.08, 0.04
    o = op * (a_true - b_true) + b_true  # history intensities
    o += rng.normal(0, 1e-4, j)
    bad = rng.permutation(j)[:12]
    o[bad] += rng.uniform(0.05, 0.2, 12) * rng.choice([-1, 1], 12)

    a, b, n_inl = calib.estimate_gains_ransac(
        jnp.asarray(o), jnp.asarray(op), jnp.ones(j, bool), jax.random.PRNGKey(0)
    )
    assert int(n_inl) >= 40
    np.testing.assert_allclose([float(a), float(b)], [a_true, b_true], atol=5e-3)


def test_process_frame_tracks_gain_drift(rng):
    """Feed a sequence whose true gain drifts; the chained estimates must
    follow (up to the deliberate epsilon anchoring)."""
    dims = calib.PhotoDims(n_history=1, n_obs=80)
    st = calib.PhotoState.zero(dims, jnp.float64)
    j = 80
    base = rng.uniform(0.2, 0.8, j)

    a_truth = [1.0]
    b_truth = [0.0]
    for f in range(5):
        # per-step relative gain
        a_rel, b_rel = 1.05, 0.01
        a_new, b_new = calib.chain_gains(a_truth[-1], b_truth[-1], a_rel, b_rel)
        a_truth.append(a_new)
        b_truth.append(b_new)
        # observed intensity in history frame f vs current frame f+1:
        # o_hist = o_cur * (a_rel - b_rel) + b_rel
        o_cur = base + rng.normal(0, 1e-4, j)
        o_hist = o_cur * (a_rel - b_rel) + b_rel
        st, a_est, b_est = calib.process_frame(
            dims, st,
            jnp.asarray(o_hist)[None, :], jnp.asarray(o_cur)[None, :],
            jnp.ones((1, j), bool), jnp.asarray([1], jnp.int32),
            jax.random.PRNGKey(f), epsilon_gap=0.0, epsilon_base=0.0,
        )
    np.testing.assert_allclose(float(a_est), a_truth[-1], atol=2e-2)
    np.testing.assert_allclose(float(b_est), b_truth[-1], atol=2e-2)


def test_spatial_solver_recovers_offsets(rng):
    """Cells with a known vignetting-like offset field: difference
    measurements must recover it up to a global constant."""
    cx, cy = 6, 4
    n = cx * cy
    xs = np.arange(n) % cx
    ys = np.arange(n) // cx
    truth = 0.05 * ((xs - cx / 2) ** 2 + (ys - cy / 2) ** 2) / 10.0

    s = 400
    sid_h = rng.integers(0, n, s)
    sid_c = rng.integers(0, n, s)
    ok = sid_h != sid_c
    vec_b = truth[sid_c] - truth[sid_h] + rng.normal(0, 1e-4, s)

    est = np.array(
        calib.estimate_spatial_parameters(
            cx, cy, jnp.asarray(sid_h, jnp.int32), jnp.asarray(sid_c, jnp.int32),
            jnp.asarray(vec_b), jnp.asarray(ok),
            gp_length_scale=1.0, gp_sigma_f=0.2, gp_sigma_n=0.005,
        )
    ).reshape(-1)
    # gauge: offsets determined up to a constant
    est -= est.mean()
    t = truth - truth.mean()
    assert np.abs(est - t).max() < 0.01, np.abs(est - t).max()


def test_correct_image_inverts_gain(rng):
    img = rng.integers(30, 220, (32, 40)).astype(np.uint8)
    # apply a gain distortion then correct with the *relative* params:
    # corrected = distorted*(a-b)+b should recover ~img when (a,b) invert it
    a, b = 1.1, 0.02
    distorted = np.clip((img / 255.0 - b) / (a - b) * 255.0, 0, 255).astype(np.uint8)
    # default path: plain clipped float correction recovers the image
    rec = np.array(calib.correct_image(jnp.asarray(distorted), a, b))
    err = np.abs(rec - img)
    assert np.median(err) < 3.0, np.median(err)

    # reference-parity path (cyclic fold + triangular LUT,
    # irPhotoCalib.cpp:24-51,422-472): LUT doubles values <128; undo for
    # comparison where valid
    rec_c = np.array(
        calib.correct_image(jnp.asarray(distorted), a, b, cyclic_lut=True)
    )
    approx = rec_c / 2.0
    mask = (img > 40) & (img < 200)
    err = np.abs(approx - img)[mask]
    assert np.median(err) < 3.0, np.median(err)
