"""Cross-agent joint-MSCKF covariance-intersection update."""
import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from x_multi_agent_jax.ekf.state import CoreState, StateDims, VisionState
from x_multi_agent_jax.vio.updates import msckf_multi

DIMS = StateDims(n_poses=6, n_features=4, buffer_size=16)
M, N = DIMS.n_poses, DIMS.n_features
D = DIMS.d


def make_agent(rng, landmark, pose_offset):
    """Window of M poses moving sideways, observing `landmark`; returns
    (vision_state_arrays, obs) where obs are generated from TRUE poses but
    the stored window carries `pose_offset` (simulating estimation error)."""
    q_arr = np.zeros((M, 4))
    p_true = np.zeros((M, 3))
    obs = np.zeros((M, 2))
    for i in range(M):
        q = Rotation.from_rotvec(rng.normal(size=3) * 0.02).as_quat()
        q_arr[i] = q
        p_true[i] = [0.3 * i, 0.05 * rng.normal(), 0.0]
        pc = Rotation.from_quat(q).as_matrix().T @ (landmark - p_true[i])
        obs[i] = pc[:2] / pc[2]
    return q_arr, p_true + pose_offset, obs


def test_joint_msckf_ci_reduces_offset(rng):
    landmark = np.array([0.8, -0.4, 6.0])
    offset = np.array([0.12, 0.0, 0.0])

    q_own, p_own, obs_own = make_agent(rng, landmark, offset)
    q_peer, p_peer, obs_peer = make_agent(rng, landmark, np.zeros(3))

    vision = VisionState(
        p_arr=jnp.asarray(p_own),
        q_arr=jnp.asarray(q_own),
        f_arr=jnp.zeros((N, 3)),
        anchor_idx=jnp.full((N,), -1, jnp.int32),
        n_valid_poses=jnp.asarray(M, jnp.int32),
        n_valid_features=jnp.asarray(0, jnp.int32),
    )
    core = CoreState.zero(jnp.float64)

    cov = jnp.eye(D) * 1e-4
    # loose prior on own window positions (they carry the offset)
    cov = cov.at[15 : 15 + 3 * M, 15 : 15 + 3 * M].add(jnp.eye(3 * M) * 0.05)
    peer_cov = jnp.eye(D) * 1e-4

    k = 2  # own track budget
    own_obs = jnp.zeros((k, M, 2)).at[0].set(jnp.asarray(obs_own))
    own_mask = jnp.zeros((k, M), bool).at[0].set(True)
    own_inlier = jnp.asarray([True, False])
    desc = rng.integers(0, 256, (1, 32)).astype(np.uint8)
    own_desc = jnp.zeros((k, 32), jnp.uint8).at[0].set(jnp.asarray(desc[0]))
    own_desc_valid = jnp.asarray([True, False])

    p_max, kt = 2, 3
    peer_trk_obs = jnp.zeros((p_max, kt, M, 2)).at[0, 1].set(jnp.asarray(obs_peer))
    peer_trk_mask = jnp.zeros((p_max, kt, M), bool).at[0, 1].set(True)
    peer_trk_desc = jnp.zeros((p_max, kt, 32), jnp.uint8).at[0, 1].set(
        jnp.asarray(desc[0])
    )
    peer_trk_desc_valid = jnp.zeros((p_max, kt), bool).at[0, 1].set(True)

    core1, vision1, cov1, n_app = msckf_multi.apply_joint_msckf_ci(
        DIMS, core, vision, cov,
        own_obs, own_mask, own_inlier, own_desc, own_desc_valid,
        jnp.broadcast_to(jnp.asarray(p_peer), (p_max, M, 3)),
        jnp.broadcast_to(jnp.asarray(q_peer), (p_max, M, 4)),
        jnp.broadcast_to(peer_cov[15 : 15 + 6 * M, 15 : 15 + 6 * M], (p_max, 6 * M, 6 * M)),
        peer_trk_obs, peer_trk_mask, peer_trk_desc, peer_trk_desc_valid,
        peer_valid=jnp.asarray([True, False]),
        sigma_img=2e-3,
        ci_msckf_w=0.3,
        oc=False,
    )
    assert int(n_app) == 1
    err_before = np.linalg.norm(np.array(vision.p_arr) - (np.array(p_own) - offset))
    err_after = np.linalg.norm(np.array(vision1.p_arr) - (np.array(p_own) - offset))
    assert np.isfinite(np.array(cov1)).all()
    np.testing.assert_allclose(np.array(cov1), np.array(cov1).T, atol=1e-9)
    assert err_after < 0.7 * err_before, (err_before, err_after)

    # negative weight requests online N-way weight optimization (reference
    # NLopt convention, ci.cpp:66-76); must stay finite and still correct
    core2, vision2, cov2, n_app2 = msckf_multi.apply_joint_msckf_ci(
        DIMS, core, vision, cov,
        own_obs, own_mask, own_inlier, own_desc, own_desc_valid,
        jnp.broadcast_to(jnp.asarray(p_peer), (p_max, M, 3)),
        jnp.broadcast_to(jnp.asarray(q_peer), (p_max, M, 4)),
        jnp.broadcast_to(peer_cov[15 : 15 + 6 * M, 15 : 15 + 6 * M], (p_max, 6 * M, 6 * M)),
        peer_trk_obs, peer_trk_mask, peer_trk_desc, peer_trk_desc_valid,
        peer_valid=jnp.asarray([True, False]),
        sigma_img=2e-3,
        ci_msckf_w=-0.3,
        oc=False,
    )
    assert int(n_app2) == 1
    assert np.isfinite(np.array(cov2)).all()
    err_opt = np.linalg.norm(np.array(vision2.p_arr) - (np.array(p_own) - offset))
    assert err_opt < 0.7 * err_before, (err_before, err_opt)
