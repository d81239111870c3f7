"""Native IO runtime (CSV IMU + PGM decode) vs NumPy ground truth."""
import os

import numpy as np
import pytest

from x_multi_agent_jax.utils import dataio


@pytest.fixture
def dataset_dir(tmp_path, rng):
    imu = np.column_stack(
        [np.arange(100) * 5e6, rng.normal(size=(100, 6))]
    )  # ns timestamps
    lines = ["# t,wx,wy,wz,ax,ay,az"]
    for row in imu:
        lines.append(",".join(f"{v:.9f}" for v in row))
    (tmp_path / "imu.csv").write_text("\n".join(lines))

    cam = tmp_path / "cam"
    cam.mkdir()
    imgs = []
    entries = ["# t,filename"]
    for i in range(3):
        img = rng.integers(0, 255, (24, 32)).astype(np.uint8)
        imgs.append(img)
        name = f"{i}.pgm"
        with open(cam / name, "wb") as f:
            f.write(b"P5\n# comment\n32 24\n255\n")
            f.write(img.tobytes())
        entries.append(f"{i * 50000000},{name}")
    (cam / "data.csv").write_text("\n".join(entries))
    return tmp_path, imu, imgs


def test_native_library_built():
    assert dataio._native(), "native/libxio.so missing — run native/build.sh"


def test_imu_csv(dataset_dir):
    root, imu, _ = dataset_dir
    got = dataio.load_imu_csv(str(root / "imu.csv"))
    # the fixture wrote 9 decimal places
    np.testing.assert_allclose(got, imu, atol=1e-9, rtol=0)


def test_pgm_roundtrip(dataset_dir):
    root, _, imgs = dataset_dir
    got = dataio.load_pgm(str(root / "cam" / "1.pgm"))
    np.testing.assert_array_equal(got, imgs[1])


def test_batch_and_euroc_layout(dataset_dir):
    root, imu, imgs = dataset_dir
    ds = dataio.load_euroc_style(str(root))
    assert len(ds.cam_paths) == 3
    np.testing.assert_allclose(ds.imu_t, imu[:, 0] * 1e-9)
    batch = dataio.load_pgm_batch(ds.cam_paths)
    np.testing.assert_array_equal(batch, np.stack(imgs))


def test_python_fallback_matches_native(dataset_dir, monkeypatch):
    root, imu, imgs = dataset_dir
    native_imu = dataio.load_imu_csv(str(root / "imu.csv"))
    native_img = dataio.load_pgm(str(root / "cam" / "0.pgm"))
    monkeypatch.setattr(dataio, "_NATIVE", False)
    np.testing.assert_array_equal(dataio.load_imu_csv(str(root / "imu.csv")), native_imu)
    np.testing.assert_array_equal(dataio.load_pgm(str(root / "cam" / "0.pgm")), native_img)