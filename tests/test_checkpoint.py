"""Checkpoint/resume: a restored filter continues bit-identically."""
import numpy as np
import jax
import jax.numpy as jnp

from x_multi_agent_jax.utils import checkpoint
from x_multi_agent_jax.utils.sim import make_circle_sim
from x_multi_agent_jax.vio import track_manager as tm
from tests.test_vio_e2e import PARAMS, TRACKS
from x_multi_agent_jax.vio import vio as vio_mod


def test_checkpoint_resume_bit_identical(tmp_path, rng):
    sim = make_circle_sim(
        duration=2.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
        match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=1,
    )
    v = vio_mod.VIO(PARAMS)
    v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))

    def feed(v, frames, imu_start):
        imu_i = imu_start
        for f in frames:
            t_cam = sim.cam_t[f]
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
        return imu_i

    imu_i = feed(v, range(10), 0)

    ckpt = str(tmp_path / "state.npz")
    checkpoint.save(ckpt, (v.fs, v.slots))

    # continue the original
    feed(v, range(10, 20), imu_i)

    # restore into a fresh instance and replay the same tail
    v2 = vio_mod.VIO(PARAMS)
    v2.init_at_time(0.0)
    v2.fs, v2.slots = checkpoint.load(ckpt, (v2.fs, v2.slots))
    feed(v2, range(10, 20), imu_i)

    a = np.array(v.tail_state().p)
    b = np.array(v2.tail_state().p)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.array(v.fs.cov), np.array(v2.fs.cov))
