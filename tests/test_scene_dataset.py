"""Scene renderer + EuRoC-style dataset writer round-trips through the
native IO path (utils/scene.py -> utils/dataio.py)."""
import os

import numpy as np

from x_multi_agent_jax.utils import dataio, scene


def test_dataset_roundtrip(tmp_path, rng):
    tex = scene.make_texture(3, size=512, octaves=3)
    info = scene.generate_agent_dataset(
        str(tmp_path), seed=7, duration=0.5, imu_rate=100.0, cam_rate=10.0,
        h=96, w=128, tex=tex,
    )
    ds = dataio.load_euroc_style(str(tmp_path), time_scale=1.0)

    np.testing.assert_allclose(ds.imu_t, info["imu_t"], atol=1e-6)
    np.testing.assert_allclose(ds.imu_w, info["imu_w"], atol=1e-8)
    np.testing.assert_allclose(ds.imu_a, info["imu_a"], atol=1e-8)
    np.testing.assert_allclose(ds.cam_t, info["cam_t"], atol=1e-6)

    imgs = dataio.load_pgm_batch(ds.cam_paths)
    assert imgs.shape == (len(ds.cam_paths), 96, 128)
    assert imgs.dtype == np.uint8
    # rendered frames carry texture (not flat) and consecutive frames of a
    # moving camera differ
    assert imgs[0].std() > 10
    assert np.abs(imgs[1].astype(int) - imgs[0].astype(int)).mean() > 0.5

    gt = np.loadtxt(os.path.join(tmp_path, "gt.csv"), delimiter=",", comments="#")
    np.testing.assert_allclose(gt[:, 1:4], info["cam_p"], atol=1e-8)


def test_texture_has_multiscale_structure():
    tex = scene.make_texture(0, size=512, octaves=4).astype(float)
    # coarse structure: block means vary; fine structure: high-pass energy
    blocks = tex.reshape(8, 64, 8, 64).mean(axis=(1, 3))
    assert blocks.std() > 5.0
    hp = tex - np.roll(tex, 1, axis=1)
    assert np.abs(hp).mean() > 2.0
