"""Drive the VIO facade in float32 (the production dtype) on whatever
device JAX finds, including the debug/observability path. Prints per-frame
error and NaN flags and runs the drop probes and debug accessors.

    python scripts/verify_drive.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np
import jax
import jax.numpy as jnp

from x_multi_agent_jax.utils import compile_cache

compile_cache.enable()

from x_multi_agent_jax.utils.sim import make_circle_sim
from x_multi_agent_jax.vio import vio as vio_mod, track_manager as tm
from test_vio_e2e import PARAMS, TRACKS

print("devices:", jax.devices())
debug = os.environ.get("VERIFY_DEBUG", "1") == "1"

sim = make_circle_sim(duration=2.0, imu_rate=100.0, cam_rate=10.0,
                      n_landmarks=30, match_budget=TRACKS.n_matches,
                      pixel_noise=1e-3, seed=0)
params = PARAMS._replace(cfg=PARAMS.cfg._replace(sigma_img=1e-3),
                         dtype="float32")
v = vio_mod.VIO(params, debug=debug)
v.init_at_time(0.0, v=np.array([1.8, 0.0, 0.0]))

imu_i = 0
errs = []
for f, t_cam in enumerate(sim.cam_t):
    while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
        v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
        imu_i += 1
    matches = tm.Matches.of(
        track_id=jnp.asarray(sim.match_id[f]),
        prev_pt=jnp.asarray(sim.match_prev[f], jnp.float32),
        cur_pt=jnp.asarray(sim.match_cur[f], jnp.float32),
        valid=jnp.asarray(sim.match_valid[f]),
    )
    applied = v.process_matches_measurement(t_cam, f, matches)
    p = np.asarray(v.anchor_state().p)
    err = float(np.linalg.norm(p - sim.cam_p[f]))
    errs.append(err)
    nan = bool(np.isnan(p).any())
    print(f"frame {f:2d} t={t_cam:.2f} applied={applied} err={err:.4f} nan={nan}")
    if nan:
        break

# probe: far-future measurement must be dropped
m0 = tm.Matches.zero(params.cfg.tracks, jnp.float32)
assert v.process_matches_measurement(999.0, 99, m0) is False, "far-future not dropped"
print("far-future probe: dropped OK")

if debug and v.last_debug is not None:
    inl, outl = v.get_msckf_tracks()
    cart = v.get_slam_features_cartesian()
    print(f"debug: msckf inl={len(inl)} outl={len(outl)} slam_cart={cart.shape}")
print("final err:", errs[-1], "max err:", max(errs))
