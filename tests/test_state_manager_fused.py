"""The fused one-sandwich ``sm.manage`` must match the sequential
remove -> reparametrize -> slide -> augment covariance application."""
import dataclasses

import numpy as np
import jax.numpy as jnp

from x_multi_agent_jax.ekf.state import CoreState, StateDims, VisionState
from x_multi_agent_jax.vio import state_manager as sm

DIMS = StateDims(n_poses=6, n_features=5, buffer_size=16)


def _random_state(rng, n_valid_feat=4, n_valid_poses=6):
    dims = DIMS
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    core = CoreState(
        time=jnp.asarray(1.0), seq=jnp.asarray(5, jnp.int32),
        p=jnp.asarray(rng.normal(size=3)), v=jnp.asarray(rng.normal(size=3)),
        q=jnp.asarray(q), b_w=jnp.asarray(rng.normal(size=3) * 0.01),
        b_a=jnp.asarray(rng.normal(size=3) * 0.01),
        w_m=jnp.zeros(3), a_m=jnp.zeros(3),
    )
    qs = rng.normal(size=(dims.n_poses, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    anchors = rng.integers(0, dims.n_poses, size=dims.n_features)
    anchors[0] = 0  # force a reparametrization
    vision = VisionState(
        p_arr=jnp.asarray(rng.normal(size=(dims.n_poses, 3))),
        q_arr=jnp.asarray(qs),
        f_arr=jnp.asarray(rng.normal(size=(dims.n_features, 3)) + 2.0),
        anchor_idx=jnp.asarray(anchors, jnp.int32),
        n_valid_poses=jnp.asarray(n_valid_poses, jnp.int32),
        n_valid_features=jnp.asarray(n_valid_feat, jnp.int32),
    )
    a = rng.normal(size=(dims.d, dims.d))
    cov = jnp.asarray(a @ a.T / dims.d + np.eye(dims.d) * 1e-3)
    return core, vision, cov


def test_fused_manage_matches_sequential(rng):
    core, vision, cov = _random_state(rng)
    lost = jnp.asarray([True, False, False, True, False])
    q_ic = jnp.asarray([0.0, 0.0, 0.0, 1.0])
    p_ic = jnp.asarray([0.1, -0.05, 0.02])

    v_f, cov_f, perm_f, nk_f = sm.manage(DIMS, core, vision, cov, lost, q_ic, p_ic)

    v_s, cov_s, perm_s, nk_s = sm.remove_features(DIMS, vision, cov, lost)
    v_s, cov_s = sm.reparametrize_features(DIMS, v_s, cov_s)
    v_s, cov_s = sm.slide_window(DIMS, v_s, cov_s)
    v_s, cov_s = sm.augment_pose(DIMS, core, v_s, cov_s, q_ic, p_ic)

    np.testing.assert_allclose(np.asarray(cov_f), np.asarray(cov_s), atol=1e-10)
    np.testing.assert_array_equal(np.asarray(perm_f), np.asarray(perm_s))
    assert int(nk_f) == int(nk_s)
    for a, b in zip(
        (v_f.p_arr, v_f.q_arr, v_f.f_arr, v_f.anchor_idx),
        (v_s.p_arr, v_s.q_arr, v_s.f_arr, v_s.anchor_idx),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_perm_matrix_equals_gather(rng):
    d = DIMS.d
    idx = jnp.asarray(rng.permutation(d), jnp.int32)
    zero = jnp.asarray(rng.random(d) < 0.3)
    cov = jnp.asarray(rng.normal(size=(d, d)))
    via_gather = sm._permute_cov(cov, idx, zero)
    p = sm._perm_matrix(idx, zero, d, cov.dtype)
    np.testing.assert_allclose(np.asarray(p @ cov @ p.T), np.asarray(via_gather),
                               atol=1e-12)
