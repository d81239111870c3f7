"""Batched feature initialization vs the sequential oracle.

The batched closed form (one covariance sandwich, state_manager.init_new_features)
must reproduce the reference's sequential insertion semantics
(``state_manager.cpp:151-198``) exactly: MSCKF-SLAM inserts in candidate
order interleaved with standard inverse-depth inserts, capacity clipping,
and cross-covariance between features inserted in the same frame.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from x_multi_agent_jax.ekf.state import StateDims, VisionState
from x_multi_agent_jax.vio import state_manager as sm

SIG_IMG = 0.007
RHO0 = 0.43
SIG_RHO0 = 0.21


def _mk_state(dims, n_valid, rng):
    d = dims.d
    n = dims.n_features
    a = rng.normal(size=(d, d))
    cov = a @ a.T + np.eye(d)
    # unused feature slots are zero rows/cols (framework invariant)
    base = 15 + 6 * dims.n_poses
    for s in range(n_valid, n):
        cov[base + 3 * s : base + 3 * s + 3, :] = 0.0
        cov[:, base + 3 * s : base + 3 * s + 3] = 0.0
    vision = VisionState.zero(dims, dtype=jnp.float64)
    vision = dataclasses.replace(
        vision,
        f_arr=jnp.asarray(rng.normal(size=(n, 3))),
        anchor_idx=jnp.asarray(rng.integers(0, dims.n_poses, size=(n,)), jnp.int32),
        n_valid_poses=jnp.asarray(dims.n_poses, jnp.int32),
        n_valid_features=jnp.asarray(n_valid, jnp.int32),
    )
    return vision, jnp.asarray(cov)


def _mk_candidates(dims, k, rng):
    d = dims.d
    n = dims.n_features
    m = dims.n_poses
    h1 = rng.normal(size=(k, 3, d))
    h1[:, :, 15 + 6 * m :] = 0.0  # Jacobian has zero feature columns
    h2 = rng.normal(size=(k, 3, 3)) + 3.0 * np.eye(3)
    r1 = rng.normal(size=(k, 3))
    feats = rng.normal(size=(k, 3))
    z = rng.normal(size=(k, 2))
    corr = rng.normal(size=(d,)) * 0.01
    return tuple(jnp.asarray(x) for x in (h1, h2, r1, feats, z, corr))


def _sequential_oracle(dims, vision, cov, is_ms, h1, h2, r1, feats, z, accept, corr):
    """Candidate-order sequential insertion (mirrors the reference loops)."""
    for i in range(accept.shape[0]):
        a_i = jnp.asarray(accept[i])[None]
        if is_ms[i]:
            vision, cov = sm.init_msckf_slam_features(
                dims, vision, cov, h1[i : i + 1], h2[i : i + 1], r1[i : i + 1],
                feats[i : i + 1], a_i, corr, SIG_IMG,
            )
        else:
            vision, cov = sm.init_standard_slam_features(
                dims, vision, cov, z[i : i + 1], a_i, RHO0, SIG_IMG, SIG_RHO0,
            )
    return vision, cov


@pytest.mark.parametrize("n_valid,pattern", [
    (3, "ms_only"),
    (3, "std_only"),
    (2, "interleaved"),
    (13, "overflow"),  # capacity clipping: only 2 of 4 accepted fit
])
def test_batched_matches_sequential(n_valid, pattern):
    rng = np.random.default_rng(hash(pattern) % 2**31)
    dims = StateDims()
    k = 6
    vision, cov = _mk_state(dims, n_valid, rng)
    h1, h2, r1, feats, z, corr = _mk_candidates(dims, k, rng)

    if pattern == "ms_only":
        is_ms = np.array([1, 1, 0, 1, 0, 1], bool)
        accept = np.array([1, 1, 0, 1, 0, 1], bool)
    elif pattern == "std_only":
        is_ms = np.zeros(k, bool)
        accept = np.array([1, 0, 1, 1, 0, 1], bool)
    elif pattern == "interleaved":
        is_ms = np.array([1, 0, 1, 0, 1, 0], bool)
        accept = np.array([1, 1, 0, 1, 1, 1], bool)
    else:  # overflow
        is_ms = np.array([1, 0, 1, 0, 1, 0], bool)
        accept = np.array([1, 1, 1, 1, 0, 0], bool)

    v_ref, c_ref = _sequential_oracle(
        dims, vision, cov, is_ms, h1, h2, r1, feats, z, accept, corr
    )
    v_bat, c_bat = sm.init_new_features(
        dims, vision, cov, jnp.asarray(is_ms), h1, h2, r1, feats, z,
        jnp.asarray(accept), corr, SIG_IMG, RHO0, SIG_RHO0,
    )

    assert int(v_bat.n_valid_features) == int(v_ref.n_valid_features)
    np.testing.assert_allclose(v_bat.f_arr, v_ref.f_arr, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(v_bat.anchor_idx, v_ref.anchor_idx)
    np.testing.assert_allclose(c_bat, c_ref, rtol=1e-9, atol=1e-10)
