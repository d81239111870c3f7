"""Reference data-ingestion: the 10-double GT match import
(/root/reference/src/x/vio/vio.cpp:372-434) and the released-dataset
layout loader drive the full filter (VERDICT r4 missing item 1).

The fixture synthesizes a dataset in the reference's on-disk formats from
the circle sim: matches.csv rows are real 10-double blocks whose
feature-equality chaining (prev features repeat the previous frame's cur
features EXACTLY, like the reference front-end emits) must reproduce the
sim's track structure through MatchAssociator.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.utils import ref_ingest
from x_multi_agent_jax.utils.sim import make_circle_sim
from x_multi_agent_jax.vision import camera as cam_mod
from x_multi_agent_jax.vio import vio as vio_mod

from tests.test_vio_e2e import PARAMS, TRACKS

CAM = cam_mod.Camera(fx=320.0, fy=320.0, cx=320.0, cy=240.0, s=0.0,
                     width=640, height=480)


def _synthesize(tmpdir, duration=3.0, seed=3):
    sim = make_circle_sim(
        duration=duration, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
        match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=seed,
    )
    # imu.csv
    with open(os.path.join(tmpdir, "imu.csv"), "w") as f:
        f.write("# t, wx, wy, wz, ax, ay, az\n")
        for i in range(len(sim.imu_t)):
            f.write(
                ",".join(
                    repr(float(v))
                    for v in [sim.imu_t[i], *sim.imu_w[i], *sim.imu_a[i]]
                )
                + "\n"
            )
    # matches.csv: 10-double blocks; prev features repeat the previous
    # frame's cur features exactly (pixel space) so equality association
    # reconstructs the tracks
    last_px = {}  # sim track id -> (t, x, y) emitted as cur last frame
    denorm = lambda pt: np.asarray(cam_mod.denormalize(CAM, jnp.asarray(pt)))
    with open(os.path.join(tmpdir, "matches.csv"), "w") as f:
        for fr, t_cam in enumerate(sim.cam_t):
            blocks = []
            new_last = {}
            for k in range(sim.match_id.shape[1]):
                if not sim.match_valid[fr, k]:
                    continue
                tid = int(sim.match_id[fr, k])
                cur = denorm(sim.match_cur[fr, k])
                if tid in last_px:
                    tp, px, py = last_px[tid]
                else:
                    tp = t_cam - 0.1
                    prev = denorm(sim.match_prev[fr, k])
                    px, py = float(prev[0]), float(prev[1])
                lm = sim.landmarks[tid]
                blocks.extend(
                    [0.0, tp, px, py, float(t_cam), float(cur[0]),
                     float(cur[1]), *map(float, lm)]
                )
                new_last[tid] = (float(t_cam), float(cur[0]), float(cur[1]))
            last_px = new_last
            f.write(
                ",".join([str(fr)] + [repr(float(v)) for v in blocks]) + "\n"
            )
    # gt.csv
    with open(os.path.join(tmpdir, "gt.csv"), "w") as f:
        for i, t in enumerate(sim.cam_t):
            f.write(
                ",".join(
                    repr(float(v))
                    for v in [t, *sim.cam_p[i], *sim.cam_q[i]]
                )
                + "\n"
            )
    return sim


def test_import_matches_block_parsing():
    vec = np.array(
        [1.0, 0.1, 100.0, 120.0, 0.2, 101.5, 119.0, 3.0, 2.0, 1.0,
         1.0, 0.1, 50.0, 60.0, 0.2, 49.0, 61.0, -1.0, -2.0, -3.0]
    )
    ref = ref_ingest.import_matches(vec, CAM)
    assert ref.cam_id.tolist() == [1, 1]
    np.testing.assert_allclose(ref.time_curr, [0.2, 0.2])
    np.testing.assert_allclose(ref.landmarks[0], [3.0, 2.0, 1.0])
    # s=0 camera: undistort is identity, normalize is linear
    want = np.asarray(cam_mod.normalize(CAM, jnp.asarray([[101.5, 119.0]])))
    np.testing.assert_allclose(ref.cur_n[0], want[0], rtol=1e-12)


def test_import_matches_rejects_bad_length():
    with pytest.raises(ValueError):
        ref_ingest.import_matches(np.zeros(13), CAM)


def test_associator_feature_equality_chaining():
    assoc = ref_ingest.MatchAssociator()
    # frame 1: two new tracks
    f1 = np.array(
        [0, 0.0, 10.0, 10.0, 0.1, 11.0, 11.0, 0, 0, 0,
         0, 0.0, 20.0, 20.0, 0.1, 21.0, 21.0, 0, 0, 0], float
    )
    ids1 = assoc.associate(f1)
    assert sorted(ids1.tolist()) == [0, 1]
    # frame 2: first continues (prev == frame-1 cur), second is new
    f2 = np.array(
        [0, 0.1, 11.0, 11.0, 0.2, 12.0, 12.0, 0, 0, 0,
         0, 0.1, 33.0, 33.0, 0.2, 34.0, 34.0, 0, 0, 0], float
    )
    ids2 = assoc.associate(f2)
    assert ids2[0] == ids1[0]
    assert ids2[1] not in ids1
    # frame 3: a track dropped in frame 2 cannot be resurrected
    f3 = np.array([0, 0.1, 21.0, 21.0, 0.3, 22.0, 22.0, 0, 0, 0], float)
    ids3 = assoc.associate(f3)
    assert ids3[0] not in set(ids1) | set(ids2)


@pytest.mark.slow
def test_dataset_loaders_drive_filter(tmp_path):
    """Both loaders end-to-end: synthesize the reference layout, load it,
    drive the full filter through imported matches, check the trajectory
    against gt.csv."""
    sim = _synthesize(str(tmp_path))
    ds = ref_ingest.load_reference_dataset(str(tmp_path), CAM)

    assert len(ds.frames) == len(sim.cam_t)
    assert ds.gt_p is not None and ds.gt_p.shape == (len(sim.cam_t), 3)
    np.testing.assert_allclose(ds.imu_w, sim.imu_w, rtol=1e-12)

    # association must reproduce the sim's track grouping 1:1 after the
    # first frame (a bijection sim_id <-> assigned_id per frame)
    for fr in range(1, len(ds.frames)):
        valid = sim.match_valid[fr]
        sim_ids = sim.match_id[fr][valid]
        got_ids = ds.frames[fr].track_id
        assert len(got_ids) == valid.sum()
        mapping = {}
        for s_id, g_id in zip(sim_ids, got_ids):
            assert mapping.setdefault(int(s_id), int(g_id)) == int(g_id)

    v = vio_mod.VIO(PARAMS)
    v.init_at_time(0.0, v=np.array([1.5 * 1.2, 0.0, 0.0]))
    imu_i = 0
    n_applied = 0
    errs = []
    for fr, t_cam in enumerate(ds.frame_t):
        while imu_i < len(ds.imu_t) and ds.imu_t[imu_i] <= t_cam + 1e-9:
            v.process_imu(
                ds.imu_t[imu_i], imu_i, ds.imu_w[imu_i], ds.imu_a[imu_i]
            )
            imu_i += 1
        matches = ref_ingest.to_device_matches(
            ds.frames[fr], TRACKS.n_matches, dtype=jnp.float64
        )
        applied = v.process_matches_measurement(t_cam, fr, matches)
        n_applied += int(applied)
        errs.append(
            np.linalg.norm(np.asarray(v.tail_state().p) - ds.gt_p[fr])
        )
    assert n_applied >= len(ds.frame_t) - 1
    assert errs[-1] < 0.3, f"final err {errs[-1]:.3f} m"
    assert max(errs) < 0.5, f"max err {max(errs):.3f} m"
